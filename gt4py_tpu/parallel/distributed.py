"""Multi-device stencil execution: IJ domain decomposition over a device mesh.

NEW functionality relative to the reference (which is single-process,
SURVEY.md §2.6): a compiled stencil is lifted to SPMD with ``shard_map`` —
each device owns an (ni/nx, nj/ny, nk) block, halos move between devices
with ``lax.ppermute`` (halo.py), and the single-device GTIR evaluator runs
unchanged on the halo-extended local block. The whole step (exchange +
compute) is one jitted program, so XLA overlaps the ppermute transfers with
independent compute where possible.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from gt4py_tpu.cartesian.backend import ksweep_triton
from gt4py_tpu.cartesian.definitions import AccessKind
from gt4py_tpu.cartesian.stencil_object import StencilObject
from gt4py_tpu.parallel.halo import exchange_halos_2d
from gt4py_tpu.parallel.mesh import CartesianMesh
from gt4py_tpu.storage.storage import Storage


class DistributedStencil:
    """SPMD wrapper around a compiled stencil.

    Usage::

        mesh = CartesianMesh()
        dist = DistributedStencil(stencil_obj, mesh)
        out = dist.apply(field_a=a, field_b=b, scalar=1.0)   # dict of written

    Fields are global (NI, NJ, NK) arrays (or Storages). NI/NJ need not be
    divisible by the mesh shape: uneven sizes are padded to the next mesh
    multiple inside the jitted program (cyclic fill under periodic
    boundaries, edge/zero fill under clamp/zero) and the written outputs
    are trimmed back — shard shapes stay static for XLA. ``boundary``
    selects the global boundary condition ("periodic" wrap / "clamp" edge
    replication / "zero"; one value or an (i, j) pair). ``backend``
    selects the per-shard compute: "jax" (fused XLA evaluator) or "gpu"
    (the same, with the K-sweep kernel for the sections it accepts).
    """

    def __init__(
        self,
        stencil: StencilObject,
        mesh: Optional[CartesianMesh] = None,
        *,
        boundary: Any = "periodic",
        backend: Optional[str] = None,
    ):
        self.stencil = stencil
        self.analyzed = stencil._analyzed
        self.mesh = mesh if mesh is not None else CartesianMesh()
        self.boundary = boundary
        self.backend = backend or (
            "gpu" if stencil.backend == "gpu" else "jax"
        )
        self.field_infos = self.analyzed.field_infos
        self.parameter_infos = self.analyzed.parameter_infos
        self.written = [
            n for n, i in self.field_infos.items() if i.access & AccessKind.WRITE
        ]
        self._cache: dict[Any, Any] = {}

    def _halo(self, name: str) -> tuple[int, int, int, int]:
        b = self.field_infos[name].boundary
        return (b.lower[0], b.upper[0], b.lower[1], b.upper[1])

    def _axis_plan(self, size: int, n_shards: int, halo_lo: int, halo_hi: int, mode: str):
        """Pad-and-trim plan for one sharded axis: (padded_size, lead, trail).

        Uneven sizes pad to the next mesh multiple; periodic boundaries use
        a cyclic fill with a leading pad >= the low halo so true-edge cells
        still read wrapped values (under clamp/zero the exchange mode itself
        serves the unpadded low edge, so only a trailing pad is needed)."""
        lead = 0
        need = size
        if size % n_shards != 0:
            if mode == "periodic":
                lead = halo_lo
                need = size + halo_lo + halo_hi
        padded = -(-need // n_shards) * n_shards
        local = padded // n_shards
        if max(halo_lo, halo_hi) > local:
            raise ValueError(
                f"Stencil halo width {max(halo_lo, halo_hi)} exceeds the "
                f"per-shard extent {local} (axis size {size} over "
                f"{n_shards} shards) — use a smaller mesh axis or a larger "
                f"domain"
            )
        return padded, lead, padded - size - lead

    def _build(self, field_names, shapes, nk):
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        mesh = self.mesh.mesh
        analyzed = self.analyzed
        written = self.written
        halos = {n: self._halo(n) for n in field_names}
        infos = self.field_infos

        # --- pad-and-trim geometry for uneven global sizes ----------------
        modes = (
            self.boundary
            if isinstance(self.boundary, (tuple, list))
            else (self.boundary, self.boundary)
        )
        size_of = {}
        for name, shape in zip(field_names, shapes):
            mask = infos[name].domain_mask
            ax = 0
            for axis_id in range(2):
                if mask[axis_id]:
                    size_of.setdefault(axis_id, shape[ax])
                    ax += 1
        halo_max = [
            (
                max((halos[n][2 * a] for n in field_names), default=0),
                max((halos[n][2 * a + 1] for n in field_names), default=0),
            )
            for a in range(2)
        ]
        plans = {}
        for axis_id, n_shards in ((0, self.mesh.nx), (1, self.mesh.ny)):
            if axis_id in size_of:
                plans[axis_id] = self._axis_plan(
                    size_of[axis_id], n_shards,
                    halo_max[axis_id][0], halo_max[axis_id][1],
                    modes[axis_id],
                )

        def _pad_axis(arr, axis, n, lead, trail, mode):
            if lead == 0 and trail == 0:
                return arr
            if mode == "periodic":
                idx = (np.arange(-lead, n + trail) % n).astype(np.int32)
                return jnp.take(arr, jnp.asarray(idx), axis=axis)
            width = [(0, 0)] * arr.ndim
            width[axis] = (lead, trail)
            if mode == "clamp":
                return jnp.pad(arr, width, mode="edge")
            return jnp.pad(arr, width)  # zero

        def pad_field(name, arr):
            mask = infos[name].domain_mask
            ax = 0
            for axis_id in range(2):
                if not mask[axis_id]:
                    continue
                padded, lead, trail = plans[axis_id]
                arr = _pad_axis(
                    arr, ax, size_of[axis_id], lead, trail, modes[axis_id]
                )
                ax += 1
            return arr

        def trim_field(name, arr):
            mask = infos[name].domain_mask
            sl = []
            for axis_id in range(2):
                if not mask[axis_id]:
                    continue
                _, lead, _ = plans[axis_id]
                sl.append(slice(lead, lead + size_of[axis_id]))
            return arr[tuple(sl)] if sl else arr

        def spec_for(name):
            mask = infos[name].domain_mask
            parts = []
            if mask[0]:
                parts.append("x")
            if mask[1]:
                parts.append("y")
            if mask[2]:
                parts.append(None)
            parts.extend([None] * len(infos[name].data_dims))
            return P(*parts)

        in_specs = tuple(spec_for(n) for n in field_names)
        out_specs = tuple(spec_for(n) for n in written)

        boundary = self.boundary
        ksweep = ksweep_triton.kernel_mode() if self.backend == "gpu" else None
        #: kernel modes that served the shard trace (filled when it traces)
        served: set[str] = set()

        def local_step(*local_arrays):
            from gt4py_tpu.cartesian.backend.evaluator import Evaluator

            arrays = {}
            origins = {}
            local_domain = None
            for name, arr in zip(field_names, local_arrays):
                i_lo, i_hi, j_lo, j_hi = halos[name]
                mask = infos[name].domain_mask
                if mask[0] and mask[1]:
                    arr = exchange_halos_2d(
                        arr, (i_lo, i_hi, j_lo, j_hi), boundary=boundary
                    )
                    if local_domain is None and mask[2]:
                        local_domain = (
                            arr.shape[0] - i_lo - i_hi,
                            arr.shape[1] - j_lo - j_hi,
                            nk,
                        )
                arrays[name] = arr
                origins[name] = (
                    i_lo if mask[0] else 0,
                    j_lo if mask[1] else 0,
                    0,
                )
            assert local_domain is not None, "Need at least one IJK field"
            scalars = dict(zip(scalar_names, local_arrays[len(field_names):]))
            ev = Evaluator(
                analyzed, local_domain, origins, arrays, scalars, ns="jax", ksweep=ksweep
            )
            out = ev.run()
            served.update(ev.kernels)
            results = []
            for name in written:
                i_lo, i_hi, j_lo, j_hi = halos[name]
                r = out[name]
                mask = infos[name].domain_mask
                sl = []
                if mask[0]:
                    sl.append(slice(i_lo, r.shape[len(sl)] - i_hi or None))
                if mask[1]:
                    sl.append(slice(j_lo, r.shape[len(sl)] - j_hi or None))
                results.append(r[tuple(sl)] if sl else r)
            return tuple(results)

        scalar_names = [
            n for n, i in self.parameter_infos.items() if i.access != AccessKind.NONE
        ]
        scalar_specs = tuple(P() for _ in scalar_names)

        fn = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=in_specs + scalar_specs,
            out_specs=out_specs,
            check_vma=False,
        )

        needs_pad = any(p[1] or p[2] for p in plans.values())
        if not needs_pad:
            return jax.jit(fn), scalar_names, served

        def padded_fn(*args):
            fields = [
                pad_field(n, a) for n, a in zip(field_names, args[: len(field_names)])
            ]
            outs = fn(*fields, *args[len(field_names):])
            return tuple(trim_field(n, o) for n, o in zip(written, outs))

        return jax.jit(padded_fn), scalar_names, served

    def lowered_hlo(self, **kwargs) -> str:
        """Compiled HLO of the SPMD step for the given fields — lets tests
        and the multichip dryrun assert the halo exchange lowers to
        collective-permutes and that no field buffer is all-gathered
        (a GSPMD regression would silently replicate the domain)."""
        import jax.numpy as jnp

        field_args = {}
        for name in self.field_infos:
            if self.field_infos[name].access == AccessKind.NONE:
                continue
            if name not in kwargs:
                raise ValueError(f"Missing value for '{name}' field.")
            value = kwargs[name]
            field_args[name] = (
                value.array if isinstance(value, Storage) else jnp.asarray(value)
            )
        field_names = tuple(field_args)
        shapes = tuple(tuple(field_args[n].shape) for n in field_names)
        nk = None
        for n in field_names:
            if self.field_infos[n].domain_mask[2]:
                nk = field_args[n].shape[self.field_infos[n].domain_ndim - 1]
                break
        key = (field_names, shapes)
        if key not in self._cache:
            self._cache[key] = self._build(field_names, shapes, nk)
        fn, scalar_names, _ = self._cache[key]
        scalars = [
            np.asarray(kwargs[name], dtype=self.parameter_infos[name].dtype)[()]
            for name in scalar_names
        ]
        args = [field_args[n] for n in field_names] + scalars
        return fn.lower(*args).compile().as_text()

    def apply(self, **kwargs) -> dict[str, Any]:
        """Run one distributed stencil step; returns {name: updated array}
        for written fields. Storage inputs are rebound in place as well."""
        import jax.numpy as jnp

        field_args = {}
        originals = {}
        for name in self.field_infos:
            if self.field_infos[name].access == AccessKind.NONE:
                continue
            if name not in kwargs:
                raise ValueError(f"Missing value for '{name}' field.")
            value = kwargs[name]
            originals[name] = value
            field_args[name] = value.array if isinstance(value, Storage) else jnp.asarray(value)

        field_names = tuple(field_args)
        shapes = tuple(tuple(field_args[n].shape) for n in field_names)
        nk = None
        for n in field_names:
            if self.field_infos[n].domain_mask[2]:
                nk = field_args[n].shape[self.field_infos[n].domain_ndim - 1]
                break
        key = (field_names, shapes)
        if key not in self._cache:
            self._cache[key] = self._build(field_names, shapes, nk)
        fn, scalar_names, served = self._cache[key]

        scalars = []
        for name in scalar_names:
            if name not in kwargs:
                raise ValueError(f"Missing value for '{name}' parameter.")
            scalars.append(
                np.asarray(kwargs[name], dtype=self.parameter_infos[name].dtype)[()]
            )

        results = fn(*(field_args[n] for n in field_names), *scalars)
        #: which path served the shards: "xla", "triton" or "triton-interpret"
        self.last_kernel = next(iter(served), "xla")
        out = dict(zip(self.written, results))
        for name, new in out.items():
            if isinstance(originals.get(name), Storage):
                originals[name].array = new
        return out
