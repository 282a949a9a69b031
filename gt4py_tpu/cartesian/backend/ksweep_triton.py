"""K-sweep kernel: one FORWARD/BACKWARD section as one Pallas kernel on
the Triton route (``backend="triton"``).

The XLA path runs such a section as a ``lax.scan`` over K
(``Evaluator._plane_scan_section``), which on a GPU is a while loop that
pays at least one kernel launch per level. This kernel follows the design
of the reference's ``gt:gpu`` backend instead: a grid of IJ tiles, each of
which walks K in a ``lax.fori_loop`` and keeps the K-offset planes of the
fields it writes (the "k-caches") as loop carries, in registers. The
per-level body is the evaluator's own plane-scan step
(``Evaluator._plane_step``) applied to tiles, so the kernel and the scan
cannot drift apart.

Everything else in the stencil stays on XLA inside the same ``jax.jit``:
PARALLEL sections, and sections that :func:`unsupported` refuses.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from gt4py_tpu import eve
from gt4py_tpu.cartesian import gtir
from gt4py_tpu.cartesian.passes.extents import _iter_reads

#: Tile of one kernel instance: (I, J) upper bounds, powers of two. J is the
#: minor axis of the K-major planes the kernel reads, so it is the long one.
#: On an H100 at 512x512x80, tiles from 4x32 to 16x32 and 1x128, 2 or 4
#: warps and 1 to 3 stages all ran within 5% of each other (PERF.md).
BLOCK = (4, 32)
NUM_WARPS = 4
NUM_STAGES = 2

_F = gtir.NativeFunction
#: Native functions whose ``jax.numpy`` form lowers on the Triton route.
#: (All but gamma, erf, erfc and round.)
_NATIVES = frozenset(set(_F) - {_F.GAMMA, _F.ERF, _F.ERFC, _F.ROUND})
_FLOAT_DTYPES = frozenset({np.dtype(np.float32), np.dtype(np.float64)})
_READ_DTYPES = _FLOAT_DTYPES | {np.dtype(np.int32), np.dtype(np.int64)}
#: fields a section may read: IJK fields by tile, K fields by level
_READ_DIMS = ((True, True, True), (False, False, True))


def kernel_mode() -> str:
    """How the kernel runs on the default JAX platform: compiled through
    Triton on a GPU, in the Pallas interpreter on the CPU (tests)."""
    import jax

    platform = jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "triton-interpret"
    raise RuntimeError(
        f"backend 'gpu' runs on a GPU, or on the CPU in interpret mode; "
        f"the default JAX platform is {platform!r}"
    )


def _dtype(ev, name: str) -> np.dtype:
    if name in ev.arrays:
        return np.dtype(ev.arrays[name].dtype)
    return np.dtype(ev._temp_dtypes[name])


def unsupported(ev, plan) -> Optional[str]:
    """Why the kernel cannot serve a plane-carry section, or None. On top
    of the plane-scan gates: no field written in the section is read at a
    horizontal offset anywhere, so IJ tiles are independent; written fields
    are float IJK fields, read-only ones IJK or K-only; no data dimensions
    or horizontal regions; only natives the Triton route lowers."""
    written = set(plan.written)
    for stmt in plan.section.body:
        if stmt.horizontal_masks:
            return "horizontal region"
        ext = ev.analyzed.stmt_extents[stmt]
        if ext.i != (0, 0) or ext.j != (0, 0):
            return "statement computed over a horizontal halo"
        for acc in (stmt.target, *_iter_reads(stmt)):
            name = acc.name
            if ev.data_ndims.get(name, 0) or acc.data_index:
                return f"field '{name}' has data dimensions"
            dtype = _dtype(ev, name)
            if name in written:
                f_ext = ev.f_ext[name]
                if f_ext.i != (0, 0) or f_ext.j != (0, 0):
                    return f"written field '{name}' is read at a horizontal offset"
                if dtype not in _FLOAT_DTYPES:
                    return f"written field '{name}' has dtype {dtype}"
            elif ev.dims.get(name) not in _READ_DIMS:
                return f"field '{name}' is neither an IJK nor a K field"
            elif dtype not in _READ_DTYPES:
                return f"field '{name}' has dtype {dtype}"
        for call in eve.walk_type(stmt, gtir.NativeFuncCall):
            if call.func not in _NATIVES:
                return f"native function {call.func}"
        for acc in eve.walk_type(stmt, gtir.ScalarAccess):
            value = ev.scalars.get(acc.name)
            if value is not None and np.dtype(getattr(value, "dtype", type(value))) not in _READ_DTYPES:
                return f"scalar '{acc.name}' has dtype {value.dtype}"
    return None


def _block(n: int, cap: int) -> int:
    b = 1
    while b < n and b < cap:
        b *= 2
    return b


def _live_out(ev, plan) -> list[str]:
    """Written fields whose levels leave the kernel: API fields, and
    temporaries read outside the section."""
    read_elsewhere = {
        acc.name
        for _, section, stmt in ev.stencil.walk_stmts()
        if section is not plan.section
        for acc in _iter_reads(stmt)
    }
    return [n for n in plan.written if n in ev.arrays or n in read_elsewhere]


def run_section(ev, plan, ks: int, ke: int, mode: str) -> None:
    """Run levels [ks, ke) of a section that :func:`unsupported` accepts and
    store the written levels into the evaluator's windows."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    live = _live_out(ev, plan)
    if not live:
        return
    ni, nj, nk = ev.domain
    bi, bj = _block(ni, BLOCK[0]), _block(nj, BLOCK[1])
    written = set(plan.written)
    body_stmts = plan.section.body
    reads = sorted({a.name for s in body_stmts for a in _iter_reads(s)} - written)
    names_in = plan.written + reads
    scalar_names = sorted({
        a.name for s in body_stmts for a in eve.walk_type(s, gtir.ScalarAccess)
        if a.name in ev.scalars
    })
    # K-major copies: a tile of one level is then contiguous along J. Read
    # in place from the (I, J, K) arrays, one level K-strided or bricks of
    # 2-8 levels picked apart in registers, the kernel ran 1.3-12x slower
    # than with the copies counted in (PERF.md).
    wins = [ev._get_window(n) for n in names_in]
    wins = [jnp.moveaxis(w, 2, 0) if w.ndim == 3 else w for w in wins]
    n_levels = {n: w.shape[0] for n, w in zip(names_in, wins)}
    k_lo = {n: ev.f_ext[n].k[0] for n in names_in}
    scalars = [jnp.reshape(jnp.asarray(ev.scalars[n]), (1,)) for n in scalar_names]
    n_sweep = ke - ks
    step = 1 if plan.forward else -1
    first = ks if plan.forward else ke - 1
    out_shape = [jax.ShapeDtypeStruct((n_sweep, ni, nj), _dtype(ev, n)) for n in live]

    def at(ref, z, i, j):
        return ref.at[z, pl.ds(i, bi), pl.ds(j, bj)]

    def kernel(*refs):
        in_refs = dict(zip(names_in, refs))
        s_refs = refs[len(names_in) : len(names_in) + len(scalar_names)]
        out_refs = dict(zip(live, refs[len(names_in) + len(scalar_names) :]))
        i0 = pl.program_id(0) * bi
        j0 = pl.program_id(1) * bj
        ii = i0 + lax.broadcasted_iota(jnp.int32, (bi, bj), 0)
        jj = j0 + lax.broadcasted_iota(jnp.int32, (bi, bj), 1)
        inside = (ii < ni) & (jj < nj)
        tile_ev = copy.copy(ev)
        tile_ev.domain = (bi, bj, nk)
        tile_ev.scalars = {n: r[0] for n, r in zip(scalar_names, s_refs)}

        def load(name, k, i, j):
            # Window levels past the edge read the edge level, as the
            # XLA scan's clamped K slabs do.
            z = jnp.clip(jnp.asarray(k - k_lo[name], jnp.int32), 0, n_levels[name] - 1)
            if i is None:  # K field: one value per level
                return in_refs[name][z]
            return plgpu.load(at(in_refs[name], z, i0 + i, j0 + j), mask=inside, other=0)

        carry0 = {
            n: tuple(load(n, first - step * dist, 0, 0) for dist in range(1, d + 1))
            for n, d in plan.depth.items()
            if d
        }

        def level(t, carry):
            k = first + step * t
            x = {(n, dk): load(n, k + dk, 0, 0) for n, dk in plan.xs_keys if n in written}

            def tile_load(name, i, j, dk):
                return load(name, k + dk, i, j)

            carry, ys = tile_ev._plane_step(
                plan, carry, x, k if plan.uses_k_iter else None, tile_load
            )
            for n in live:
                ref = at(out_refs[n], jnp.asarray(k - ks, jnp.int32), i0, j0)
                plgpu.store(ref, ys[n].astype(ref.dtype), mask=inside)
            return carry

        lax.fori_loop(np.int32(0), np.int32(n_sweep), level, carry0)

    outs = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(pl.cdiv(ni, bi), pl.cdiv(nj, bj)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=mode == "triton-interpret",
        name=f"ksweep_{ev.stencil.name}",
    )(*wins, *scalars)
    for n, levels in zip(live, outs):
        ev._set_levels(n, ks, jnp.moveaxis(levels, 0, 2))

