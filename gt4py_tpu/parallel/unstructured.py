"""Distributed unstructured meshes with EXPLICIT ghost rows.

The GSPMD path (``parallel/next_fields.py``) lets XLA partition
connectivity gathers however it likes — correct, but an irregular gather
over a sharded codomain generally lowers to all-gathers. Real ICON-style
consumers partition the mesh so each rank owns a contiguous, spatially
compact block of every element kind and REMOTE accesses touch only a thin
halo owned by ring neighbors; the exchange is then two fixed-width slab
sends per axis step (reference has nothing here — gt4py delegates
distribution to GHEX; SURVEY.md §2.6 "connectivity tables become sharded
gather indices").

Recipe here (composes ``next/mesh_utils.py`` renumbering with a 1-D
device ring):

1. :func:`ring_partition` — contiguous equal blocks of each element kind
   (apply ``mesh_utils.spatial_renumbering`` FIRST so contiguous id
   blocks are spatially compact and ghosts land on ring neighbors).
2. :func:`partition_gather` — per-shard LOCAL connectivity tables whose
   stored indices address a shard-extended value buffer
   ``[lo-halo | owned | hi-halo]``; halo widths are uniform across
   shards (SPMD), computed from the worst shard.
3. :func:`halo_gather` — inside ``shard_map``: two ``lax.ppermute`` slab
   exchanges over the ring (collective-permutes, never all-gather),
   concatenation, then the ordinary local gather.

Plan-time validation rejects meshes whose ghosts reach beyond the
immediate ring neighbors (raise, never silently widen) — renumber first.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

__all__ = [
    "DistributedUnstructured",
    "ring_partition",
    "partition_gather",
    "halo_gather",
    "ShardedGather",
]


def ring_partition(n_elements: int, n_parts: int) -> np.ndarray:
    """Block starts of a contiguous equal partition: part p owns
    ``[starts[p], starts[p+1])``. Requires ``n_parts`` to divide
    ``n_elements`` (uniform SPMD block shapes)."""
    if n_elements % n_parts != 0:
        raise ValueError(
            f"{n_elements} elements do not split evenly over {n_parts} parts"
        )
    w = n_elements // n_parts
    return np.arange(n_parts + 1) * w


class ShardedGather:
    """Per-shard gather plan produced by :func:`partition_gather`.

    Attributes:
        local_tables: (n_rows, deg) int32 — global row order, values are
            LOCAL indices into the shard-extended buffer of the owning
            row shard. Shard it by rows (axis 0) on the same mesh axis
            as the values.
        halo_lo / halo_hi: uniform slab widths pulled from the previous /
            next ring neighbor.
        n_local: owned values per shard.
    """

    def __init__(self, local_tables, halo_lo, halo_hi, n_local, n_parts):
        self.local_tables = local_tables
        self.halo_lo = int(halo_lo)
        self.halo_hi = int(halo_hi)
        self.n_local = int(n_local)
        self.n_parts = int(n_parts)


def partition_gather(
    table: np.ndarray,
    n_values: int,
    n_parts: int,
    *,
    skip_value: Optional[int] = None,
) -> ShardedGather:
    """Build the explicit-ghost plan for ``values[table]`` with rows and
    values both ring-partitioned into ``n_parts`` contiguous blocks.

    For each row shard p (owning rows ``[p*Rw, (p+1)*Rw)`` and values
    ``[p*Vw, (p+1)*Vw)``), every referenced value must be owned by p or
    by its ring neighbors p±1 (mod P) — else raises ``ValueError``
    (renumber the mesh first, ``next/mesh_utils.py``). Stored indices are
    rewritten to address ``[lo-halo | owned | hi-halo]`` where the halos
    are the TRAILING ``halo_lo`` rows of the previous shard and the
    LEADING ``halo_hi`` rows of the next (fixed-width slabs, uniform
    across shards — the ppermute exchange shape).
    """
    table = np.asarray(table)
    n_rows, deg = table.shape
    rstarts = ring_partition(n_rows, n_parts)
    vstarts = ring_partition(n_values, n_parts)
    Vw = n_values // n_parts

    valid = np.ones(table.shape, dtype=bool)
    if skip_value is not None:
        valid = table != skip_value
    t = np.clip(table, 0, n_values - 1)

    # Worst-case halo widths over all shards (uniform SPMD shapes).
    halo_lo = 0
    halo_hi = 0
    for p in range(n_parts):
        rows = slice(rstarts[p], rstarts[p + 1])
        tp = t[rows]
        vp = valid[rows]
        lo, hi = vstarts[p], vstarts[p + 1]
        prev_lo = (lo - Vw) % n_values
        next_hi = (hi + Vw - 1) % n_values + 1
        owned = vp & (tp >= lo) & (tp < hi)
        below = vp & ~owned & _in_ring_range(tp, prev_lo, lo, n_values)
        above = vp & ~owned & ~below & _in_ring_range(
            tp, hi % n_values, next_hi, n_values
        )
        foreign = vp & ~owned & ~below & ~above
        if foreign.any():
            r, c = np.nonzero(foreign)
            raise ValueError(
                f"shard {p}: row {rstarts[p] + r[0]} references value "
                f"{int(tp[r[0], c[0]])}, beyond ring neighbors "
                f"[{prev_lo}, {next_hi}) — renumber the mesh "
                f"(next/mesh_utils.py) so ghosts are neighbor-local"
            )
        if below.any():
            # distance back from the owned block start (1 .. Vw)
            d = (lo - tp[below]) % n_values
            halo_lo = max(halo_lo, int(d.max()))
        if above.any():
            d = (tp[above] - hi) % n_values + 1
            halo_hi = max(halo_hi, int(d.max()))

    # Local index rewrite: extended buffer [lo-halo | owned | hi-halo].
    local = np.zeros_like(t, dtype=np.int64)
    for p in range(n_parts):
        rows = slice(rstarts[p], rstarts[p + 1])
        tp = t[rows]
        lo, hi = vstarts[p], vstarts[p + 1]
        owned = (tp >= lo) & (tp < hi)
        below = _in_ring_range(tp, (lo - halo_lo) % n_values, lo, n_values)
        # below: local slot = halo_lo - distance
        dist_back = (lo - tp) % n_values
        loc = np.where(owned, tp - lo + halo_lo, 0)
        loc = np.where(below & ~owned, halo_lo - dist_back, loc)
        above = ~owned & ~below
        dist_fwd = (tp - hi) % n_values
        loc = np.where(above, halo_lo + Vw + dist_fwd, loc)
        local[rows] = loc
    if skip_value is not None:
        # Preserve the marker so consumers' mask machinery (which tests
        # ``table != skip_value``) keeps working on the LOCAL table; the
        # gather itself clips indices into range (halo_gather).
        local[~valid] = skip_value

    return ShardedGather(
        local.astype(np.int32), halo_lo, halo_hi, Vw, n_parts
    )


def _in_ring_range(x, lo, hi, n):
    """Membership in the cyclic interval [lo, hi) of Z_n."""
    if lo <= hi:
        return (x >= lo) & (x < hi)
    return (x >= lo) | (x < hi)


class _ShardedConn:
    """Per-shard stand-in for a Connectivity inside ``shard_map``: the
    embedded remap path detects ``sharded_gather`` and routes the gather
    through the explicit-ghost halo exchange instead of host shift-plan
    analysis (the table block is a traced array). Mirrors the attribute
    surface ``Field._remap_connectivity`` consumes."""

    def __init__(self, table_block, plan, axis_name, conn):
        self.table = table_block  # (local_rows, deg), traced
        self._plan = plan
        self._axis_name = axis_name
        self.codomain = conn.codomain
        self.source_dim = conn.source_dim
        self.neighbor_dim = conn.neighbor_dim
        self.skip_value = conn.skip_value

    def sharded_gather(self, values, column):
        table = self.table if column is None else self.table[:, column]
        return halo_gather(values, table, self._plan, self._axis_name)


class DistributedUnstructured:
    """Field-view operators on ring-partitioned unstructured meshes —
    the distributed counterpart of the embedded execution path
    (cartesian analog: ``parallel.distributed.DistributedStencil``).

    Takes the plain field-view operator (``remap``/``neighbor_sum`` DSL,
    reference common.py:991,1150 semantics) plus GLOBAL connectivities,
    and runs it SPMD over a 1-D device ring with explicit ghost rows:

    - every element kind is ring-partitioned into contiguous blocks
      (uneven sizes pad to the next multiple and trim on the way out);
    - each connectivity becomes a per-shard LOCAL table addressing a
      shard-extended value buffer (:func:`partition_gather`);
    - remote rows arrive as two fixed-width ``lax.ppermute`` slab
      exchanges per table (collective-permutes — never an
      all-gather), validated by tests at the HLO level;
    - ``skip_value`` masking flows through the embedded mask machinery
      end-to-end.

    Meshes must be numbered so ghosts are ring-neighbor-local — pass
    ``renumberings`` (``next.mesh_utils.Renumbering``, e.g. from
    ``spatial_renumbering``) to apply a numbering first; tables AND the
    corresponding field data are permuted consistently.

    Usage::

        dist = DistributedUnstructured(
            nabla, offset_provider={"E2V": e2v, "V2E": v2e},
            sizes={V: n_vertices, E: n_edges},
        )
        out = dist(pp, s_x, sign, vol)   # global Fields in, global Field out
    """

    def __init__(
        self,
        field_op,
        *,
        offset_provider: dict,
        sizes: dict,
        n_parts: Optional[int] = None,
        axis_name: str = "ring",
        mesh=None,
        renumberings: Optional[list] = None,
    ):
        import jax

        self.field_op = field_op
        self.axis_name = axis_name
        if mesh is None:
            from jax.sharding import Mesh

            devices = np.asarray(jax.devices())
            if n_parts is not None:
                devices = devices[:n_parts]
            mesh = Mesh(devices, axis_names=(axis_name,))
        self.mesh = mesh
        self.n_parts = int(np.prod(mesh.devices.shape))

        # Consistent renumbering of tables (field data is permuted per
        # call in __call__).
        self._renumberings = {r.dim: r for r in (renumberings or [])}
        self._sizes = dict(sizes)
        self._pad = {
            dim: (-(-int(n) // self.n_parts) * self.n_parts) - int(n)
            for dim, n in self._sizes.items()
        }

        self._conns = {}
        self._plans = {}
        self._tables = {}
        for name, conn in offset_provider.items():
            for r in self._renumberings.values():
                if r.dim in (conn.source_dim, conn.codomain):
                    conn = r.apply(conn)
            table = np.asarray(conn.table)
            n_rows_pad = self._padded(conn.source_dim)
            n_vals_pad = self._padded(conn.codomain)
            if table.shape[0] < n_rows_pad:
                # Padding rows gather value 0 and are trimmed on output.
                fill = np.zeros(
                    (n_rows_pad - table.shape[0], table.shape[1]),
                    dtype=table.dtype,
                )
                table = np.concatenate([table, fill], axis=0)
            plan = partition_gather(
                table, n_vals_pad, self.n_parts, skip_value=conn.skip_value
            )
            self._conns[name] = conn
            self._plans[name] = plan
            self._tables[name] = plan.local_tables

    def _padded(self, dim) -> int:
        return int(self._sizes[dim]) + self._pad[dim]

    def __call__(self, *fields):
        """Apply to GLOBAL embedded Fields; returns a global Field over
        the operator's output dimension (padding trimmed)."""
        import gt4py_tpu.next as gtx

        sharded, tables, blocks, out_dims = self._prepare(fields)
        out_arr = sharded(tuple(tables), *blocks)

        # Trim padding and un-renumber the output dimension.
        out_dim = out_dims[0]
        if out_dim not in self._sizes:
            raise ValueError(
                f"operator output dimension {out_dim} is not ring-"
                f"partitioned (sizes={sorted(d.value for d in self._sizes)})"
            )
        n_out = int(self._sizes[out_dim])
        arr = np.asarray(out_arr)[:n_out]
        r = self._renumberings.get(out_dim)
        if r is not None:
            arr = arr[r.perm]  # back to the user's numbering
        return gtx.as_field(list(out_dims), arr)

    def compiled_hlo(self, *fields) -> str:
        """Compiled HLO of the SPMD program for the given fields — used
        by tests and the multichip dryrun to assert the exchange lowers
        to collective-permutes and never all-gathers field values."""
        sharded, tables, blocks, _ = self._prepare(fields)
        return sharded.lower(tuple(tables), *blocks).compile().as_text()

    def _prepare(self, fields):
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from jax.experimental.shard_map import shard_map

        import gt4py_tpu.next as gtx
        from gt4py_tpu.next.embedded import Field, offset_provider_context

        defn = getattr(self.field_op, "definition", self.field_op)

        blocks = []
        dims_list = []
        for f in fields:
            if not isinstance(f, Field):
                raise TypeError(
                    "DistributedUnstructured takes embedded Fields "
                    f"(got {type(f).__name__}); build them with gtx.as_field"
                )
            arr = np.asarray(f.ndarray)
            dims = f.dims
            lead = dims[0]
            if lead not in self._sizes:
                raise ValueError(
                    f"leading dimension {lead} of a field is not in sizes="
                    f"{sorted(d.value for d in self._sizes)}"
                )
            r = self._renumberings.get(lead)
            if r is not None:
                arr = r.permute_data(arr)
            pad = self._padded(lead) - arr.shape[0]
            if pad:
                arr = np.concatenate(
                    [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0
                )
            blocks.append(jnp.asarray(arr))
            dims_list.append(dims)

        names = sorted(self._tables)
        tables = [jnp.asarray(self._tables[n]) for n in names]
        ax = self.axis_name
        out_dims_holder: list = []  # captured during tracing (static)

        def spmd(table_blocks, *field_blocks):
            provider = {
                n: _ShardedConn(tb, self._plans[n], ax, self._conns[n])
                for n, tb in zip(names, table_blocks)
            }
            local_fields = [
                gtx.as_field(list(dims), blk)
                for dims, blk in zip(dims_list, field_blocks)
            ]
            with offset_provider_context(provider):
                res = defn(*local_fields)
            if not out_dims_holder:
                out_dims_holder.append(res.dims)
            return res.ndarray

        table_specs = tuple(P(ax) for _ in names)
        field_specs = tuple(P(ax) for _ in blocks)
        sharded = jax.jit(
            shard_map(
                spmd,
                mesh=self.mesh,
                in_specs=(table_specs, *field_specs),
                out_specs=P(ax),
            )
        )
        # Resolve the (static) output dims by tracing once.
        jax.eval_shape(sharded, tuple(tables), *blocks)
        return sharded, tables, blocks, out_dims_holder[0]


def halo_gather(values, local_table, plan: ShardedGather, axis_name: str):
    """Inside ``shard_map``: exchange halo slabs with the ring neighbors
    (two ``lax.ppermute``s — collective-permutes) and gather through
    the shard's local table. ``values``: (n_local, ...) owned block;
    ``local_table``: this shard's (rows_local, deg) block of
    ``plan.local_tables``."""
    import jax.numpy as jnp
    from jax import lax

    n = lax.axis_size(axis_name)
    parts = [values]
    if plan.halo_lo:
        send = values[-plan.halo_lo :]
        recv = lax.ppermute(
            send, axis_name, [(i, (i + 1) % n) for i in range(n)]
        )
        parts.insert(0, recv)
    if plan.halo_hi:
        send = values[: plan.halo_hi]
        recv = lax.ppermute(
            send, axis_name, [(i, (i - 1) % n) for i in range(n)]
        )
        parts.append(recv)
    ext = jnp.concatenate(parts, axis=0) if len(parts) > 1 else values
    safe = jnp.clip(local_table, 0, ext.shape[0] - 1)
    return jnp.take(ext, safe, axis=0)
