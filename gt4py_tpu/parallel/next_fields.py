"""Distributed field-view fields: GSPMD sharding for the next DSL.

NEW functionality relative to the reference (single-process, SURVEY.md
§2.6). Unlike the cartesian path — which runs the evaluator under
``shard_map`` with explicit ``ppermute`` halo exchange
(parallel/distributed.py) — field operators are pure ``jnp`` programs
(shifted slices, gathers, scans), so the distribution story here is
GSPMD: place the backing arrays with a ``NamedSharding`` mapping field
dimensions onto mesh axes and call operators normally under ``jax.jit``;
XLA partitions the program and inserts the halo ``collective-permute``s
between devices automatically.
"""

from __future__ import annotations

from typing import Optional, Sequence

from gt4py_tpu.next.common import Dimension
from gt4py_tpu.next.embedded import Field
from gt4py_tpu.parallel.mesh import CartesianMesh


def field_sharding(
    mesh: CartesianMesh,
    field_dims: Sequence[Dimension],
    dim_map: dict[Dimension, str],
):
    """NamedSharding for a field: ``dim_map`` maps field dimensions to mesh
    axis names ('x'/'y'); unmapped dimensions replicate."""
    from jax.sharding import NamedSharding, PartitionSpec

    spec = PartitionSpec(*(dim_map.get(d) for d in field_dims))
    return NamedSharding(mesh.mesh, spec)


def shard_field(
    field: Field,
    mesh: CartesianMesh,
    dim_map: Optional[dict[Dimension, str]] = None,
) -> Field:
    """Place a Field's array sharded over the mesh (default: first two
    horizontal dimensions onto the mesh's x/y axes). Shifted reads in
    operators applied to the result become collective-permutes under
    GSPMD — the next-DSL halo exchange."""
    import jax

    if dim_map is None:
        from gt4py_tpu.next.common import DimensionKind

        horizontal = [d for d in field.dims if d.kind != DimensionKind.VERTICAL]
        axes = ["x", "y"]
        dim_map = {d: axes[i] for i, d in enumerate(horizontal[: len(axes)])}
    sharding = field_sharding(mesh, field.dims, dim_map)
    return Field(field.domain, jax.device_put(field.ndarray, sharding), field.mask)


def constrain_field(field: Field, mesh: CartesianMesh, dim_map: dict[Dimension, str]) -> Field:
    """``with_sharding_constraint`` on a field inside a jitted operator —
    pins intermediate layouts so XLA keeps the decomposition."""
    import jax

    sharding = field_sharding(mesh, field.dims, dim_map)
    return Field(
        field.domain,
        jax.lax.with_sharding_constraint(field.ndarray, sharding),
        field.mask,
    )
