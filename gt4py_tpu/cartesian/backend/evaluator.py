"""Vectorized GTIR execution engine.

This module is the replacement for the reference's code
generators: where the reference emits NumPy source (gtc/numpy/npir_codegen.py)
or C++/CUDA (gtc/gtcpp/, gtc/dace/), this engine *traces* the lowered GTIR
directly into array operations:

- with ``ns="numpy"`` it executes eagerly on NumPy arrays (the reference's
  ``numpy`` backend semantics — the correctness oracle); field *windows* are
  views, so mutation semantics match the reference exactly,
- with ``ns="jax"`` the same trace runs under ``jax.jit``:

  * every field gets a *window* — the sub-array the stencil actually
    touches (domain extended by the field's access extent); temporaries are
    windows only and never see device-memory round-trips XLA can't fuse away,
  * PARALLEL units trace to shifted-slice arithmetic on windows, which XLA
    fuses into single kernels,
  * FORWARD/BACKWARD sections trace to ``lax.scan`` with **plane carries**
    (or, on the ``gpu`` backend, to the K-sweep kernel, ksweep_triton.py):
    the K-offset-read planes of fields written in the section ride the scan
    carry (depth = max offset — the reference's K-cache analysis,
    gtc/passes/oir_optimizations/caches.py:92), other fields stream in as
    stacked xs slices, and outputs stack as ys. No dynamic full-array
    updates anywhere on the hot path.

Semantics notes (mirroring the reference's generated code):
- every statement unit executes over the compute domain extended by its
  access extent (per-statement extents from passes/extents.py, the analog of
  OIR HorizontalExecution extents),
- conditional writes are masked selects (both branches evaluated), matching
  the reference's OIR mask lowering,
- in FORWARD/BACKWARD loops, K-offset reads of fields written in the same
  section observe already-updated values (basis of tridiagonal solvers,
  reference gtscript.rst:120-137); positive-offset reads in FORWARD (and
  negative in BACKWARD) observe pre-section values.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

from gt4py_tpu.cartesian import gtir
from gt4py_tpu.cartesian.backend import ksweep_triton
from gt4py_tpu.cartesian.definitions import Extent
from gt4py_tpu.cartesian.passes.extents import iter_writes, _iter_reads
from gt4py_tpu.cartesian.passes.pipeline import AnalyzedStencil

# Max sequential-section length that is unrolled instead of scanned.
_UNROLL_MAX = 3


def _np_unary_vec(fn):
    vec = np.vectorize(fn)

    def impl(x):
        out = vec(x)
        return out if isinstance(out, np.ndarray) else np.asarray(out)

    return impl


class _NamespaceOps:
    """Array-namespace dispatch (NumPy eager vs JAX traced)."""

    def __init__(self, kind: str):
        self.kind = kind
        if kind == "jax":
            import jax
            import jax.numpy as jnp

            self.jax = jax
            self.xp = jnp
        else:
            self.jax = None
            self.xp = np

    def slice_nd(self, arr, starts, sizes):
        from gt4py_tpu.core import ndarray_utils

        if self.kind != "jax":
            assert all(isinstance(s, (int, np.integer)) for s in starts)
        return ndarray_utils.slice_nd(arr, starts, sizes, xp=self.xp)

    def update_nd(self, arr, starts, value):
        from gt4py_tpu.core import ndarray_utils

        return ndarray_utils.update_nd(arr, starts, value, xp=self.xp)

    def take_along_k(self, arr, idx):
        xp = self.xp
        idx = xp.clip(idx, 0, arr.shape[2] - 1)
        return xp.take_along_axis(arr, idx, axis=2)

    def put_along_k(self, arr, idx, value, valid):
        """Masked per-gridpoint scatter along K (variable-K-offset
        writes): lanes with out-of-range indices — or ``valid`` False —
        keep their old value (dropped, not clamped-overwritten)."""
        xp = self.xp
        nk = arr.shape[2]
        safe = xp.clip(idx, 0, nk - 1)
        inb = (idx >= 0) & (idx < nk)
        ok = inb if valid is None else xp.logical_and(valid, inb)
        old = xp.take_along_axis(arr, safe, axis=2)
        new = xp.where(ok, value, old)
        if self.kind == "numpy":
            xp.put_along_axis(arr, safe, new, axis=2)
            return arr
        return xp.put_along_axis(arr, safe, new, axis=2, inplace=False)

    def iota(self, n: int, axis: int, shape3) -> Any:
        vec = self.xp.arange(n, dtype=np.int64)
        reshape = [1, 1, 1]
        reshape[axis] = n
        return vec.reshape(reshape)


def _native_impls(ops: _NamespaceOps) -> dict:
    xp = ops.xp
    if ops.kind == "jax":
        import jax.scipy.special as jsp

        gamma_fn = getattr(jsp, "gamma", None)
        if gamma_fn is None:
            def gamma_fn(x):
                return xp.exp(jsp.gammaln(x)) * xp.where(
                    (x < 0) & (xp.floor(x / 2) * 2 != xp.floor(x)), -1.0, 1.0
                )
        erf_fn, erfc_fn = jsp.erf, jsp.erfc
    else:
        gamma_fn = _np_unary_vec(math.gamma)
        erf_fn = _np_unary_vec(math.erf)
        erfc_fn = _np_unary_vec(math.erfc)

    F = gtir.NativeFunction
    return {
        F.ABS: xp.abs,
        F.MIN: xp.minimum,
        F.MAX: xp.maximum,
        F.MOD: xp.mod,
        F.SIN: xp.sin,
        F.COS: xp.cos,
        F.TAN: xp.tan,
        F.ASIN: xp.arcsin,
        F.ACOS: xp.arccos,
        F.ATAN: xp.arctan,
        F.SINH: xp.sinh,
        F.COSH: xp.cosh,
        F.TANH: xp.tanh,
        F.ASINH: xp.arcsinh,
        F.ACOSH: xp.arccosh,
        F.ATANH: xp.arctanh,
        F.SQRT: xp.sqrt,
        F.CBRT: xp.cbrt,
        F.EXP: xp.exp,
        F.LOG: xp.log,
        F.LOG10: xp.log10,
        F.GAMMA: gamma_fn,
        F.ISFINITE: xp.isfinite,
        F.ISINF: xp.isinf,
        F.ISNAN: xp.isnan,
        F.FLOOR: xp.floor,
        F.CEIL: xp.ceil,
        F.TRUNC: xp.trunc,
        F.ROUND: xp.round,
        F.ROUND_AWAY_FROM_ZERO: lambda x: xp.trunc(
            x + xp.copysign(xp.asarray(0.5, dtype=_dt(x)), x)
        ),
        F.ERF: erf_fn,
        F.ERFC: erfc_fn,
        F.POW: xp.power,
        F.ATAN2: xp.arctan2,
        F.HYPOT: xp.hypot,
        F.COPYSIGN: xp.copysign,
        F.FMA: lambda a, b, c: a * b + c,
    }


def _dt(x):
    return getattr(x, "dtype", np.float64)


def _apply_binop(xp, op, left, right):
    A = gtir.ArithmeticOperator
    C = gtir.ComparisonOperator
    L = gtir.LogicalOperator
    if isinstance(op, C):
        # Half-float comparisons widen ONLY the half operand to f32, which
        # embeds it exactly (bit-identical result) — the other side keeps
        # its dtype (an f64/int64 counterpart must not be narrowed) and
        # ordinary promotion finishes the job. Applied in every backend
        # for parity.
        from gt4py_tpu.core.definitions import HALF_FLOAT_DTYPES

        if getattr(left, "dtype", None) in HALF_FLOAT_DTYPES:
            left = xp.asarray(left).astype(np.float32)
        if getattr(right, "dtype", None) in HALF_FLOAT_DTYPES:
            right = xp.asarray(right).astype(np.float32)
    if op == A.ADD:
        return xp.add(left, right)
    if op == A.SUB:
        return xp.subtract(left, right)
    if op == A.MUL:
        return xp.multiply(left, right)
    if op == A.DIV:
        return xp.true_divide(left, right)
    if op == A.MOD:
        return xp.mod(left, right)
    if op == A.POW:
        return xp.power(left, right)
    if op == A.MATMUL:
        # '@' on data-dimension fields (reference visit_MatMult,
        # gtscript_frontend.py:1506): grid axes (always rank 3 here) are
        # batch dims; the trailing data dims multiply. NumPy's 1-D vector
        # special case doesn't apply to batched operands, so vectors get an
        # explicit trailing/leading axis.
        # A float32 product on the GPU runs in TF32 (about three decimal
        # digits) unless asked for full precision.
        kw = {} if xp is np else {"precision": "highest"}
        ld, rd = left.ndim - 3, right.ndim - 3
        if ld == 2 and rd == 1:
            return xp.matmul(left, right[..., None], **kw)[..., 0]
        if ld == 1 and rd == 2:
            return xp.matmul(left[..., None, :], right, **kw)[..., 0, :]
        return xp.matmul(left, right, **kw)
    if op == C.EQ:
        return xp.equal(left, right)
    if op == C.NE:
        return xp.not_equal(left, right)
    if op == C.LT:
        return xp.less(left, right)
    if op == C.LE:
        return xp.less_equal(left, right)
    if op == C.GT:
        return xp.greater(left, right)
    if op == C.GE:
        return xp.greater_equal(left, right)
    if op == L.AND:
        return xp.logical_and(left, right)
    if op == L.OR:
        return xp.logical_or(left, right)
    raise TypeError(op)


class _Ctx:
    """Evaluation context for one unit: extent + K window.

    ``plane`` (sequential plane-scan mode) carries the read/write resolver
    dicts; ``k_seq`` is the current sequential K (Python int or traced)."""

    __slots__ = ("ext", "ks", "ke", "k_seq", "nk_static", "plane")

    def __init__(self, ext: Extent, ks, ke, k_seq, plane=None):
        self.ext = ext
        self.ks = ks
        self.ke = ke
        self.k_seq = k_seq
        self.nk_static = 1 if k_seq is not None else int(ke - ks)
        self.plane = plane


class _PlaneCtxData:
    """Read/write state for one iteration of a plane-carry scan."""

    __slots__ = (
        "section_written", "forward", "carry", "xs", "current", "k_value", "tile_load"
    )

    def __init__(
        self, section_written, forward, carry, xs, current, k_value=None, tile_load=None
    ):
        self.section_written = section_written
        self.forward = forward
        self.carry = carry
        self.xs = xs
        self.current = current
        #: traced absolute K index of this level (None unless the section
        #: reads the iteration index)
        self.k_value = k_value
        #: K-sweep kernel tiles: ``tile_load(name, i, j, dk)`` loads the
        #: tile of a field not written in the section at window offset
        #: (i, j) and K offset ``dk`` (None on the XLA scan)
        self.tile_load = tile_load


class _PlanePlan:
    """What one K level of a sequential section reads and carries."""

    __slots__ = ("section", "forward", "written", "depth", "xs_keys", "uses_k_iter")

    def __init__(self, section, forward, written, depth, xs_keys, uses_k_iter):
        self.section = section
        self.forward = forward
        #: fields written in the section (sorted)
        self.written = written
        #: written field -> number of already-computed planes its reads need
        self.depth = depth
        #: (field, dk) planes read at pre-section values
        self.xs_keys = xs_keys
        self.uses_k_iter = uses_k_iter


_K_ITER = ("__iteration_k__", 0)


class _PlaneUnsupported(Exception):
    pass


class Evaluator:
    """Executes one analyzed stencil for a concrete (domain, origins) set."""

    def __init__(
        self,
        analyzed: AnalyzedStencil,
        domain: tuple[int, int, int],
        origins: dict[str, tuple[int, int, int]],
        arrays: dict[str, Any],
        scalars: dict[str, Any],
        ns: str,
        ksweep: Optional[str] = None,
    ):
        self.analyzed = analyzed
        self.stencil = analyzed.stencil
        self.domain = domain
        self.origins = dict(origins)
        self.arrays = dict(arrays)
        self.scalars = scalars
        self.ops = _NamespaceOps(ns)
        self.natives = _native_impls(self.ops)
        #: K-sweep kernel mode ("triton" or "triton-interpret") tried for
        #: plane-carry sections; None keeps every section on the XLA scan
        self.ksweep = ksweep
        #: kernel modes that served a section of this trace
        self.kernels: set[str] = set()

        self.dims: dict[str, tuple[bool, bool, bool]] = {}
        self.data_ndims: dict[str, int] = {}
        self.f_ext: dict[str, Extent] = {}
        for p in self.stencil.params:
            if isinstance(p, gtir.FieldDecl):
                self.dims[p.name] = p.dimensions
                self.data_ndims[p.name] = len(p.data_dims)
            elif isinstance(p, gtir.GlobalTableDecl):
                self.dims[p.name] = (False, False, False)
                self.data_ndims[p.name] = len(p.shape)
        for name in list(self.arrays):
            self.f_ext[name] = analyzed.field_extents.get(name, Extent.zeros())
        for t in self.stencil.temporaries:
            self.f_ext[t.name] = analyzed.field_extents.get(t.name, Extent.zeros())
            self.dims[t.name] = (True, True, True)
            self.data_ndims[t.name] = 0
        self._setup_windows()

    # -- windows -----------------------------------------------------------

    def _win_shape(self, name: str) -> tuple[int, ...]:
        ni, nj, nk = self.domain
        ext = self.f_ext[name]
        dims = self.dims[name]
        shape = []
        if dims[0]:
            shape.append(ni + ext.i[1] - ext.i[0])
        if dims[1]:
            shape.append(nj + ext.j[1] - ext.j[0])
        if dims[2]:
            shape.append(nk + ext.k[1] - ext.k[0])
        return tuple(shape)

    def _setup_windows(self) -> None:
        """Create per-field windows: the sub-arrays the stencil touches.
        NumPy windows are views (in-place); JAX windows are functional.

        K windows that extend past the array edge (scan compositions read
        k±1 over the WHOLE column; boundary levels select the value away)
        clamp to the boundary level — the same semantics as the K-sweep
        kernel and the debug backend — materialized as edge padding on
        read-only fields."""
        self.win: dict[str, Any] = {}
        self._win_slices: dict[str, tuple] = {}
        for name, arr in self.arrays.items():
            dims = self.dims.get(name, (True, True, True))
            if not any(dims):  # GlobalTable
                self.win[name] = arr
                continue
            ext = self.f_ext[name]
            origin = self.origins.get(name, (0, 0, 0))
            sl = []
            k_pad = (0, 0)
            for ax, (present, lo, size) in enumerate(
                zip(dims, (ext.i[0], ext.j[0], ext.k[0]), self._win_shape(name))
            ):
                if present:
                    start = origin[ax] + lo
                    if ax == 2:
                        n = arr.shape[len(sl)]
                        lo_pad = max(0, -start)
                        hi_pad = max(0, start + size - n)
                        if lo_pad or hi_pad:
                            info = self.analyzed.field_infos.get(name)
                            from gt4py_tpu.cartesian.definitions import AccessKind

                            if info is not None and info.access & AccessKind.WRITE:
                                raise IndexError(
                                    f"K access extent of written field '{name}' "
                                    f"exceeds its allocation"
                                )
                            k_pad = (lo_pad, hi_pad)
                            start, size = max(start, 0), min(start + size, n) - max(start, 0)
                    sl.append(slice(start, start + size))
            sl = tuple(sl) + (slice(None),) * self.data_ndims.get(name, 0)
            window = arr[sl]
            if k_pad != (0, 0):
                kax = sum(dims[:2])
                pad = [(0, 0)] * window.ndim
                pad[kax] = k_pad
                window = (
                    np.pad(window, pad, mode="edge")
                    if self.ops.kind == "numpy"
                    else self.ops.xp.pad(window, pad, mode="edge")
                )
            else:
                self._win_slices[name] = sl
            self.win[name] = window
        # Temporaries: lazily-allocated windows.
        for t in self.stencil.temporaries:
            self.win[t.name] = None
        self._temp_dtypes = {
            t.name: (t.dtype if t.dtype is not None else np.float64)
            for t in self.stencil.temporaries
        }

    def _get_window(self, name: str):
        w = self.win[name]
        if w is None:  # unwritten temporary: undefined values read as zeros
            w = self.ops.xp.zeros(self._win_shape(name), dtype=self._temp_dtypes[name])
            self.win[name] = w
        return w

    # -- main entry --------------------------------------------------------

    def run(self) -> dict[str, Any]:
        for vloop in self.stencil.vertical_loops:
            if vloop.loop_order == gtir.LoopOrder.PARALLEL:
                self._run_parallel(vloop)
            else:
                self._run_sequential(vloop)
        # Write windows back into the full arrays (JAX mode; NumPy windows
        # are views and already wrote through).
        if self.ops.kind == "jax":
            for name, sl in self._win_slices.items():
                if name in self.arrays and self.win[name] is not None:
                    self.arrays[name] = self.arrays[name].at[sl].set(self.win[name])
        return self.arrays

    # -- parallel loops ----------------------------------------------------

    def _run_parallel(self, vloop: gtir.VerticalLoop) -> None:
        nk = self.domain[2]
        for section in vloop.sections:
            ks, ke = section.interval.resolve(nk)
            if ke <= ks:
                continue
            for stmt in section.body:
                self._exec_unit(stmt, ks, ke, None)

    # -- sequential loops --------------------------------------------------

    def _run_sequential(self, vloop: gtir.VerticalLoop) -> None:
        nk = self.domain[2]
        backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
        for section in vloop.sections:
            ks, ke = section.interval.resolve(nk)
            if ke <= ks:
                continue
            length = ke - ks
            if self.ops.kind == "jax" and length > _UNROLL_MAX:
                try:
                    plan = self._plane_plan(section, backward)
                except _PlaneUnsupported:
                    plan = None
                if plan is not None:
                    if self.ksweep is not None and ksweep_triton.unsupported(self, plan) is None:
                        ksweep_triton.run_section(self, plan, ks, ke, self.ksweep)
                        self.kernels.add(self.ksweep)
                    else:
                        self._plane_scan_section(plan, ks, ke)
                    continue
            k_range = range(ks, ke)
            if backward:
                k_range = reversed(k_range)
            for k in k_range:
                for stmt in section.body:
                    self._exec_unit(stmt, k, k + 1, k)

    # -- plane-carry scan --------------------------------------------------

    def _plane_plan(self, section, backward: bool) -> "_PlanePlan":
        """Which planes one K level of ``section`` reads and carries;
        raises :class:`_PlaneUnsupported` for constructs the plane scan
        cannot express."""
        forward = not backward
        written = sorted({w.name for stmt in section.body for w in iter_writes(stmt)})
        written_set = set(written)

        def is_updated_read(dk: int) -> bool:
            return dk < 0 if forward else dk > 0

        read_pairs: set[tuple[str, int]] = set()
        for stmt in section.body:
            if isinstance(stmt, gtir.While):
                raise _PlaneUnsupported("while in sequential section")
            for wacc in iter_writes(stmt):
                if wacc.offset[2] != 0 or wacc.koffset is not None:
                    # K-offset writes need the whole K column live, not
                    # plane carries — served by the per-level loop.
                    raise _PlaneUnsupported("K-offset write in sequential section")
            for access in _iter_reads(stmt):
                if not any(self.dims.get(access.name, (True,) * 3)):
                    continue  # GlobalTable: read directly
                if access.koffset is not None or access.abs_k is not None:
                    raise _PlaneUnsupported("dynamic K read in sequential section")
                if not self.dims[access.name][2]:
                    continue  # K-less fields read directly from windows
                read_pairs.add((access.name, access.offset[2]))
            for w in iter_writes(stmt):
                if not self.dims[w.name][2]:
                    raise _PlaneUnsupported("write to K-less field in scan")
                if not all(self.dims[w.name][:2]):
                    # The carry planes are (I, J) 2-D; a J-less/I-less
                    # written field would need reduced-rank carries — use
                    # the per-level path instead.
                    raise _PlaneUnsupported("write to lower-dim field in scan")

        depth: dict[str, int] = {f: 0 for f in written}
        xs_keys: set[tuple[str, int]] = {(f, 0) for f in written}
        for name, dk in read_pairs:
            if name in written_set and is_updated_read(dk):
                depth[name] = max(depth[name], abs(dk))
            else:
                xs_keys.add((name, dk))

        from gt4py_tpu import eve

        uses_k_iter = any(
            isinstance(n, gtir.IteratorAccess)
            for stmt in section.body
            for n in eve.walk_values(stmt)
        )
        return _PlanePlan(section, forward, written, depth, sorted(xs_keys), uses_k_iter)

    def _k_rel(self, name: str, k: int) -> int:
        """Window-relative index of absolute level ``k`` of ``name``."""
        return k - self.f_ext[name].k[0]

    def _plane_step(self, plan: "_PlanePlan", carry, x, k_value, tile_load=None):
        """One K level of a plane-carry section: the body shared by the
        XLA scan and the K-sweep kernel. ``carry[name]`` holds the planes
        of levels already computed (nearest first); ``x[(name, dk)]`` the
        pre-section plane of ``name`` at offset ``dk``. Returns the new
        carry and the written planes of this level."""
        plane = _PlaneCtxData(
            set(plan.written), plan.forward, carry, x, {}, k_value, tile_load
        )
        for stmt in plan.section.body:
            ext = self.analyzed.stmt_extents[stmt]
            ctx = _Ctx(ext, 0, 1, 0, plane)
            assert isinstance(stmt, gtir.Assign)
            value = self._broadcast(self.eval_expr(stmt.value, ctx), ctx)
            mask = self._full_mask(stmt, ctx)
            self._plane_write(stmt.target, value, mask, ctx)
        new_carry = {}
        for name, planes in carry.items():
            cur = plane.current.get(name)
            if cur is None:
                cur = x[(name, 0)]
            new_carry[name] = (cur,) + planes[:-1]
        ys = {name: plane.current.get(name, x[(name, 0)]) for name in plan.written}
        return new_carry, ys

    def _plane_scan_section(self, plan: "_PlanePlan", ks: int, ke: int) -> None:
        import jax.numpy as jnp
        from jax import lax

        forward = plan.forward

        def window_k_slab(name: str, k0: int, k1: int):
            """(NI, NJ, L) K-slab of a field window, clamped to the window
            (out-of-window reads are undefined-by-spec; clamp keeps shapes)."""
            w = self._get_window(name)
            dims = self.dims[name]
            assert dims[2]
            kax = sum(dims[:2])
            z0, z1 = self._k_rel(name, k0), self._k_rel(name, k1)
            pad_lo = max(0, -z0)
            pad_hi = max(0, z1 - w.shape[kax])
            z0c, z1c = max(z0, 0), min(z1, w.shape[kax])
            slab = w[(slice(None),) * kax + (slice(z0c, z1c),)]
            if pad_lo or pad_hi:
                edge_lo = w[(slice(None),) * kax + (slice(0, 1),)]
                edge_hi = w[(slice(None),) * kax + (slice(-1, None),)]
                parts = [jnp.repeat(edge_lo, pad_lo, axis=kax)] if pad_lo else []
                parts.append(slab)
                if pad_hi:
                    parts.append(jnp.repeat(edge_hi, pad_hi, axis=kax))
                slab = jnp.concatenate(parts, axis=kax)
            return slab

        xs = {}
        for name, dk in plan.xs_keys:
            slab = window_k_slab(name, ks + dk, ke + dk)
            kax = sum(self.dims[name][:2])
            xs[(name, dk)] = jnp.moveaxis(slab, kax, 0)  # (L, ...)
        # Iterator-access (current-K) reads: stream the absolute K index as
        # an extra scan input (lax.scan's reverse handles BACKWARD order).
        if plan.uses_k_iter:
            xs[_K_ITER] = jnp.arange(ks, ke, dtype=np.int32)

        step = 1 if forward else -1
        first_k = ks if forward else ke - 1
        carry0 = {}
        for name, d in plan.depth.items():
            if d:
                carry0[name] = tuple(
                    jnp.squeeze(
                        window_k_slab(name, first_k - step * dist, first_k - step * dist + 1),
                        axis=2,
                    )
                    for dist in range(1, d + 1)
                )

        def body(carry, x):
            return self._plane_step(plan, carry, x, x.get(_K_ITER))

        _, ys = lax.scan(body, carry0, xs, reverse=not forward)
        for name in plan.written:
            self._set_levels(name, ks, jnp.moveaxis(ys[name], 0, 2))

    def _set_levels(self, name: str, ks: int, levels) -> None:
        """Store ``levels`` (NI, NJ, L) into the window of ``name`` from
        absolute level ``ks`` on."""
        w = self._get_window(name)
        z0 = self._k_rel(name, ks)
        idx = (slice(None), slice(None), slice(z0, z0 + levels.shape[2]))
        self.win[name] = w.at[idx].set(levels.astype(w.dtype))

    def _plane_read(self, access: gtir.FieldAccess, ctx: _Ctx):
        """Resolve a field read inside a plane-carry scan iteration; returns
        an IJ plane (2-D) for the field's window."""
        plane = ctx.plane
        name = access.name
        dk = access.offset[2]
        forward = plane.forward
        if name in plane.section_written:
            updated = dk < 0 if forward else dk > 0
            if updated:
                return plane.carry[name][abs(dk) - 1]
            if dk == 0:
                cur = plane.current.get(name)
                if cur is not None:
                    return cur
                return plane.xs[(name, 0)]
            return plane.xs[(name, dk)]
        return plane.xs[(name, dk)]

    def _plane_write(self, target: gtir.FieldAccess, value, mask, ctx: _Ctx) -> None:
        xp = self.ops.xp
        plane = ctx.plane
        name = target.name
        ext = ctx.ext
        f_ext = self.f_ext[name]
        base = plane.current.get(name)
        if base is None:
            base = plane.xs[(name, 0)]
        # value shape: (NI_u, NJ_u, 1) -> 2-D plane
        value2d = xp.squeeze(value, axis=2).astype(base.dtype)
        mask2d = xp.squeeze(mask, axis=2) if mask is not None else None
        NI_u, NJ_u = value2d.shape
        xi = ext.i[0] - f_ext.i[0]
        xj = ext.j[0] - f_ext.j[0]
        if (xi, xj) == (0, 0) and (NI_u, NJ_u) == base.shape[:2]:
            plane.current[name] = (
                value2d if mask2d is None else xp.where(mask2d, value2d, base)
            )
            return
        sub = base[xi : xi + NI_u, xj : xj + NJ_u]
        if mask2d is not None:
            value2d = xp.where(mask2d, value2d, sub)
        plane.current[name] = base.at[xi : xi + NI_u, xj : xj + NJ_u].set(value2d)

    # -- unit execution ----------------------------------------------------

    def _exec_unit(self, stmt: gtir.Stmt, ks, ke, k_seq) -> None:
        ext = self.analyzed.stmt_extents[stmt]
        ctx = _Ctx(ext, ks, ke, k_seq)
        if isinstance(stmt, gtir.Assign):
            value = self._broadcast_target(
                self.eval_expr(stmt.value, ctx), ctx, stmt.target
            )
            mask = self._full_mask(stmt, ctx)
            self._write(stmt.target, value, mask, ctx)
        elif isinstance(stmt, gtir.While):
            self._exec_while(stmt, ctx)
        else:
            raise TypeError(type(stmt).__name__)

    def _full_mask(self, stmt, ctx: _Ctx) -> Optional[Any]:
        mask = None
        if stmt.mask is not None:
            mask = self._broadcast(self.eval_expr(stmt.mask, ctx), ctx)
        if stmt.horizontal_masks:
            rmask = self._region_mask(stmt.horizontal_masks, ctx)
            mask = rmask if mask is None else self.ops.xp.logical_and(mask, rmask)
        return mask

    def _exec_while(self, stmt: gtir.While, ctx: _Ctx, outer_mask=None) -> None:
        xp = self.ops.xp

        involved = sorted(
            {w.name for w in iter_writes(stmt)}
            | {
                r.name
                for r in _iter_reads(stmt)
                if r.name in self.win and any(self.dims.get(r.name, ()))
            }
        )

        def eval_mask() -> Any:
            cond = self._broadcast(self.eval_expr(stmt.cond, ctx), ctx)
            extra = self._full_mask(stmt, ctx)
            if extra is not None:
                cond = xp.logical_and(cond, extra)
            if outer_mask is not None:
                cond = xp.logical_and(cond, outer_mask)
            return cond

        def apply_body(mask) -> None:
            for s in stmt.body:
                if isinstance(s, gtir.Assign):
                    value = self._broadcast_target(
                        self.eval_expr(s.value, ctx), ctx, s.target
                    )
                    smask = self._full_mask(s, ctx)
                    total = mask if smask is None else xp.logical_and(mask, smask)
                    self._write(s.target, value, total, ctx)
                elif isinstance(s, gtir.While):
                    # nested while: the outer iteration mask gates the inner
                    # loop (points done with the outer loop must not change)
                    self._exec_while(s, ctx, outer_mask=mask)
                else:
                    raise TypeError(type(s).__name__)

        if self.ops.kind == "numpy":
            mask = eval_mask()
            while bool(np.any(mask)):
                apply_body(mask)
                mask = eval_mask()
            return

        import jax.lax as lax

        def cond_fn(state):
            self.win.update(zip(involved, state))
            return self.ops.xp.any(eval_mask())

        def body_fn(state):
            self.win.update(zip(involved, state))
            apply_body(eval_mask())
            return tuple(self.win[n] for n in involved)

        state0 = tuple(self._get_window(n) for n in involved)
        final = lax.while_loop(cond_fn, body_fn, state0)
        self.win.update(zip(involved, final))

    # -- reads/writes ------------------------------------------------------

    def _window_shape(self, ctx: _Ctx) -> tuple[int, int, int]:
        ni, nj, _ = self.domain
        ext = ctx.ext
        return (
            ni + ext.i[1] - ext.i[0],
            nj + ext.j[1] - ext.j[0],
            ctx.nk_static,
        )

    def _read_field(self, access: gtir.FieldAccess, ctx: _Ctx) -> Any:
        name = access.name
        dims = self.dims[name]
        Ni, Nj, Nk = self._window_shape(ctx)

        if not any(dims):  # GlobalTable: pure data-index lookup
            idx = tuple(self.eval_expr(e, ctx) for e in access.data_index)
            return self.win[name][idx]

        # Plane-scan context: K-ful fields resolve via the plane machinery.
        if ctx.plane is not None and dims[2]:
            di, dj, dk = access.offset
            ext = ctx.ext
            f_ext = self.f_ext[name]
            xi = ext.i[0] + di - f_ext.i[0] if dims[0] else None
            xj = ext.j[0] + dj - f_ext.j[0] if dims[1] else None
            plane = ctx.plane
            if plane.tile_load is not None and name not in plane.section_written:
                value = plane.tile_load(name, xi, xj, dk)
            else:
                sl = []
                if dims[0]:
                    sl.append(slice(xi, xi + Ni))
                if dims[1]:
                    sl.append(slice(xj, xj + Nj))
                value = self._plane_read(access, ctx)[tuple(sl)]
            # re-add the K axis (length 1) ahead of any data dimensions
            value = self.ops.xp.expand_dims(value, sum(dims[:2]))
            value = self._expand_missing(value, (dims[0], dims[1], True), Ni, Nj, Nk)
            if access.data_index:
                value = self._apply_data_index(value, access.data_index, ctx)
            return value

        w = self._get_window(name)
        ext = ctx.ext
        f_ext = self.f_ext[name]
        origin = self.origins.get(name, (0, 0, 0))
        di, dj, dk = access.offset
        data_ndim = self.data_ndims.get(name, 0)

        starts = []
        sizes = []
        gather = access.koffset is not None or access.abs_k is not None
        if dims[0]:
            starts.append(ext.i[0] + di - f_ext.i[0])
            sizes.append(Ni)
        if dims[1]:
            starts.append(ext.j[0] + dj - f_ext.j[0])
            sizes.append(Nj)
        if dims[2] and not gather:
            base = ctx.ks if ctx.k_seq is None else ctx.k_seq
            starts.append(base + dk - f_ext.k[0])
            sizes.append(Nk)

        if gather:
            xp = self.ops.xp
            window = self.ops.slice_nd(w, starts, sizes) if starts else w
            window = self._expand_missing(window, (dims[0], dims[1], True), Ni, Nj, Nk)
            if access.abs_k is not None:
                kidx = xp.asarray(self.eval_expr(access.abs_k, ctx)) - f_ext.k[0]
            else:
                base = ctx.ks if ctx.k_seq is None else ctx.k_seq
                k_iota = self.ops.iota(Nk, 2, None) if ctx.k_seq is None else 0
                koff = self.eval_expr(access.koffset, ctx)
                kidx = xp.asarray(base + dk + k_iota + koff - f_ext.k[0])
            kidx = xp.broadcast_to(kidx.astype(np.int64), (Ni, Nj, Nk))
            data_shape = tuple(window.shape[3:])
            if data_shape:
                # data-dim fields: gather K per gridpoint, broadcast the
                # index over the trailing data dims
                kidx = xp.broadcast_to(
                    kidx.reshape((Ni, Nj, Nk) + (1,) * len(data_shape)),
                    (Ni, Nj, Nk) + data_shape,
                )
            value = self.ops.take_along_k(
                xp.broadcast_to(window, (Ni, Nj) + tuple(window.shape[2:])), kidx
            )
            if access.data_index:
                value = self._apply_data_index(value, access.data_index, ctx)
            return value

        value = self.ops.slice_nd(w, starts, sizes)
        value = self._expand_missing(value, dims, Ni, Nj, Nk)
        if access.data_index:
            value = self._apply_data_index(value, access.data_index, ctx)
        return value

    def _expand_missing(self, value, dims, Ni, Nj, Nk) -> Any:
        axis = 0
        for present in dims:
            if not present:
                value = self.ops.xp.expand_dims(value, axis)
            axis += 1
        return value

    def _eval_static_index(self, expr: gtir.Expr, ctx: _Ctx):
        value = self.eval_expr(expr, ctx)
        if isinstance(value, np.ndarray) and value.ndim == 0:
            return int(value)
        if isinstance(value, (int, np.integer)):
            return int(value)
        if hasattr(value, "ndim") and value.ndim == 0:
            return value  # traced scalar index
        return None  # per-gridpoint index: caller gathers

    def _apply_data_index(self, value, index_exprs, ctx: _Ctx):
        """Index the trailing data dimensions; scalar indices slice,
        per-gridpoint (array-valued) indices gather along the data axis
        (reference gtscript_frontend.py:1290 data-dims subscripting)."""
        xp = self.ops.xp
        axis = 3  # first data axis after (I, J, K)
        for expr in index_exprs:
            idx = self._eval_static_index(expr, ctx)
            if idx is not None:
                value = value[(slice(None),) * axis + (idx,)]
                continue
            iv = self._broadcast(self.eval_expr(expr, ctx), ctx)
            iv = xp.asarray(iv).astype(np.int64)
            iv = xp.clip(iv, 0, value.shape[axis] - 1)
            # broadcast the (I, J, K)-shaped index over remaining data dims
            iv = xp.broadcast_to(
                iv.reshape(iv.shape[:3] + (1,) * (value.ndim - 3)),
                value.shape[:axis] + (1,) + value.shape[axis + 1 :],
            )
            value = xp.take_along_axis(value, iv, axis=axis)
            value = xp.squeeze(value, axis=axis)
        return value

    def _write(self, target: gtir.FieldAccess, value, mask, ctx: _Ctx) -> None:
        xp = self.ops.xp
        name = target.name
        if ctx.plane is not None:
            self._plane_write(target, value, mask, ctx)
            return
        if target.koffset is not None:
            self._write_variable_k(target, value, mask, ctx)
            return
        dims = self.dims[name]
        ext = ctx.ext
        f_ext = self.f_ext[name]
        Ni, Nj, Nk = self._window_shape(ctx)
        w = self._get_window(name) if (self.win.get(name) is not None or mask is not None or target.data_index) else None

        value = self._broadcast_target(value, ctx, target)

        starts = []
        shape_out = []
        if dims[0]:
            starts.append(ext.i[0] - f_ext.i[0])
            shape_out.append(Ni)
        if dims[1]:
            starts.append(ext.j[0] - f_ext.j[0])
            shape_out.append(Nj)
        if dims[2]:
            base = ctx.ks if ctx.k_seq is None else ctx.k_seq
            # K-offset writes (sequential loops only) land at k + dk.
            starts.append(base + target.offset[2] - f_ext.k[0])
            shape_out.append(Nk)
        elif Nk != 1:
            raise NotImplementedError(
                f"Writing field '{name}' without K axis over a multi-level section"
            )

        squeeze_axes = tuple(i for i, present in enumerate(dims) if not present)
        if squeeze_axes:
            value = xp.squeeze(value, axis=squeeze_axes)

        if w is None:
            # Unallocated temporary with a plain write.
            win_shape = self._win_shape(name)
            dtype = self._temp_dtypes[name]
            value = xp.asarray(value).astype(dtype)
            if tuple(shape_out) == win_shape and all(
                isinstance(s, (int, np.integer)) and s == 0 for s in starts
            ):
                self.win[name] = value
                return
            w = self._get_window(name)

        value = xp.asarray(value).astype(w.dtype)
        # Full-window unmasked writes replace the window outright.
        if (
            mask is None
            and not target.data_index
            and tuple(shape_out) == tuple(w.shape[: len(shape_out)])
            and (not self.data_ndims.get(name, 0) or value.shape == w.shape)
            and all(isinstance(s, (int, np.integer)) and s == 0 for s in starts)
        ):
            if self.ops.kind == "numpy":
                w[...] = value
            else:
                self.win[name] = value
            return

        def _expand_mask(m, like):
            if m is not None and like.ndim > m.ndim:
                m = m.reshape(m.shape + (1,) * (like.ndim - m.ndim))
            return m

        if mask is not None:
            if squeeze_axes:
                mask = xp.squeeze(mask, axis=squeeze_axes)
            old = self.ops.slice_nd(w, starts, shape_out)
            if target.data_index:
                idx = tuple(self._eval_static_index(e, ctx) for e in target.data_index)
                if any(i is None for i in idx):
                    new = self._set_data_index(old, target.data_index, value, mask, ctx)
                else:
                    old_elem = old[(Ellipsis,) + idx]
                    sel = xp.where(_expand_mask(mask, old_elem), value, old_elem)
                    if self.ops.kind == "numpy":
                        old[(Ellipsis,) + idx] = sel
                        new = old
                    else:
                        new = old.at[(Ellipsis,) + idx].set(sel)
            else:
                new = xp.where(_expand_mask(mask, value), value, old)
            self.win[name] = self.ops.update_nd(w, starts, new)
        else:
            if target.data_index:
                idx = tuple(self._eval_static_index(e, ctx) for e in target.data_index)
                old = self.ops.slice_nd(w, starts, shape_out)
                if any(i is None for i in idx):
                    block = self._set_data_index(old, target.data_index, value, None, ctx)
                elif self.ops.kind == "numpy":
                    old[(Ellipsis,) + idx] = value
                    block = old
                else:
                    block = old.at[(Ellipsis,) + idx].set(value)
                self.win[name] = self.ops.update_nd(w, starts, block)
            else:
                self.win[name] = self.ops.update_nd(w, starts, value)

    def _write_variable_k(
        self, target: gtir.FieldAccess, value, mask, ctx: _Ctx
    ) -> None:
        """Per-gridpoint variable-K-offset write (``A[0, 0, lev] = x``
        with runtime ``lev``; reference test_code_generation.py
        ::test_K_offset_write_conditional). Sequential loops only; out-of-
        range target levels are dropped, mirroring the clamped-read
        policy's bounds safety without corrupting boundary levels."""
        xp = self.ops.xp
        name = target.name
        dims = self.dims[name]
        if target.data_index:
            raise NotImplementedError(
                "variable-K-offset write combined with data-dimension indexing"
            )
        if not (dims[0] and dims[1] and dims[2]):
            raise NotImplementedError(
                "variable-K-offset writes require a full IJK field"
            )
        if ctx.k_seq is None:
            raise RuntimeError(
                "variable-K-offset write outside a sequential loop "
                "(should have been rejected at parse time)"
            )
        ext = ctx.ext
        f_ext = self.f_ext[name]
        Ni, Nj, Nk = self._window_shape(ctx)
        w = self._get_window(name)
        value = self._broadcast_target(value, ctx, target)

        starts = [ext.i[0] - f_ext.i[0], ext.j[0] - f_ext.j[0]]
        sizes = [Ni, Nj]
        block = self.ops.slice_nd(w, starts, sizes)  # (Ni, Nj, K_window)
        koff = self._broadcast(self.eval_expr(target.koffset, ctx), ctx)
        kidx = xp.asarray(
            ctx.k_seq + target.offset[2] + koff - f_ext.k[0]
        ).astype(np.int64)
        kidx = xp.broadcast_to(kidx, (Ni, Nj, Nk))
        value = xp.broadcast_to(xp.asarray(value).astype(w.dtype), (Ni, Nj, Nk))
        if mask is not None:
            mask = xp.broadcast_to(mask, (Ni, Nj, Nk))
        new_block = self.ops.put_along_k(block, kidx, value, mask)
        if self.ops.kind == "numpy":
            # slice_nd returned a view; put_along_k wrote through.
            return
        self.win[name] = self.ops.update_nd(w, starts, new_block)

    def _set_data_index(self, old, index_exprs, value, mask, ctx: _Ctx):
        """Per-gridpoint data-index WRITE: blend ``value`` into ``old`` at
        the (possibly array-valued) data indices via one-hot selection
        (data dims are small, so the select is cheap and scatter-free)."""
        xp = self.ops.xp
        dd = old.ndim - 3
        if len(index_exprs) != dd:
            raise NotImplementedError(
                "partial per-gridpoint data-dimension writes are not supported"
            )
        cond = None
        for d, expr in enumerate(index_exprs):
            iv = self._eval_static_index(expr, ctx)
            if iv is None:
                iv = self._broadcast(self.eval_expr(expr, ctx), ctx)
            iv = xp.asarray(iv).astype(np.int64)
            iv = iv.reshape(iv.shape + (1,) * dd) if iv.ndim == 3 else iv
            shape_iota = (1, 1, 1) + tuple(
                old.shape[3 + t] if t == d else 1 for t in range(dd)
            )
            iota = xp.arange(old.shape[3 + d], dtype=np.int64).reshape(shape_iota)
            c = iota == iv
            cond = c if cond is None else xp.logical_and(cond, c)
        if mask is not None:
            cond = xp.logical_and(cond, mask.reshape(mask.shape + (1,) * dd))
        valx = xp.asarray(value)
        if valx.ndim == 3:
            valx = valx.reshape(valx.shape + (1,) * dd)
        return xp.where(cond, valx, old)

    def _region_mask(self, hmasks, ctx: _Ctx) -> Any:
        xp = self.ops.xp
        ni, nj, _ = self.domain
        Ni, Nj, Nk = self._window_shape(ctx)
        i_rel = self.ops.iota(Ni, 0, None) + ctx.ext.i[0]
        j_rel = self.ops.iota(Nj, 1, None) + ctx.ext.j[0]
        total = None
        for hm in hmasks:
            cond = xp.ones((1, 1, 1), dtype=bool)
            for rel, interval, size in ((i_rel, hm.i, ni), (j_rel, hm.j, nj)):
                if interval.start is not None:
                    cond = xp.logical_and(cond, rel >= interval.start.resolve(size))
                if interval.end is not None:
                    cond = xp.logical_and(cond, rel < interval.end.resolve(size))
            total = cond if total is None else xp.logical_and(total, cond)
        return xp.broadcast_to(total, (Ni, Nj, Nk))

    def _broadcast(self, value, ctx: _Ctx) -> Any:
        shape = self._window_shape(ctx)
        return self.ops.xp.broadcast_to(self.ops.xp.asarray(value), shape)

    def _broadcast_target(self, value, ctx: _Ctx, target: gtir.FieldAccess) -> Any:
        """Broadcast an assignment's RHS to the target's full value shape —
        (Ni, Nj, Nk) plus the remaining (unindexed) data dimensions for
        vector/matrix assignments like ``out = mat @ vec`` (reference
        unrolls these in defir_to_gtir.py:123,195; here they stay whole)."""
        xp = self.ops.xp
        shape = self._window_shape(ctx)
        dd = self._data_shape(target.name)
        rest = dd[len(target.data_index):] if dd else ()
        if rest:
            value = xp.asarray(value)
            # a grid-shaped value (leading dims == window) gets new trailing
            # axes; pure data values ((M,) constants) trail-align naturally
            if value.ndim == 3 and tuple(value.shape) == shape:
                value = value.reshape(value.shape + (1,) * len(rest))
            return xp.broadcast_to(value, shape + rest)
        return xp.broadcast_to(xp.asarray(value), shape)

    def _data_shape(self, name: str) -> tuple[int, ...]:
        info = self.analyzed.field_infos.get(name)
        if info is not None:
            return tuple(info.data_dims or ())
        w = self.win.get(name)
        if w is not None and w.ndim > 3:
            return tuple(w.shape[3:])
        return ()

    # -- expression evaluation --------------------------------------------

    def eval_expr(self, expr: gtir.Expr, ctx: _Ctx) -> Any:
        xp = self.ops.xp
        if isinstance(expr, gtir.Literal):
            return np.asarray(expr.value, dtype=expr.dtype)[()]
        if isinstance(expr, gtir.ScalarAccess):
            return self.scalars[expr.name]
        if isinstance(expr, gtir.FieldAccess):
            return self._read_field(expr, ctx)
        if isinstance(expr, gtir.UnaryOp):
            v = self.eval_expr(expr.expr, ctx)
            if expr.op == gtir.UnaryOperator.NOT:
                return xp.logical_not(v)
            if expr.op == gtir.UnaryOperator.NEG:
                return xp.negative(v)
            return v
        if isinstance(expr, gtir.BinaryOp):
            left = self.eval_expr(expr.left, ctx)
            right = self.eval_expr(expr.right, ctx)
            return _apply_binop(xp, expr.op, left, right)
        if isinstance(expr, gtir.TernaryOp):
            cond = self.eval_expr(expr.cond, ctx)
            t = self.eval_expr(expr.true_expr, ctx)
            f = self.eval_expr(expr.false_expr, ctx)
            return xp.where(cond, t, f)
        if isinstance(expr, gtir.NativeFuncCall):
            args = [self.eval_expr(a, ctx) for a in expr.args]
            return self.natives[expr.func](*args)
        if isinstance(expr, gtir.Cast):
            v = self.eval_expr(expr.expr, ctx)
            return xp.asarray(v).astype(expr.dtype)
        if isinstance(expr, gtir.IteratorAccess):
            dtype = expr.dtype if expr.dtype is not None else np.dtype(np.int64)
            if ctx.plane is not None:
                return ctx.plane.k_value.astype(dtype)
            if ctx.k_seq is not None:
                if isinstance(ctx.k_seq, (int, np.integer)):
                    return np.asarray(ctx.k_seq, dtype=dtype)[()]
                return xp.asarray(ctx.k_seq).astype(dtype)
            return (self.ops.iota(ctx.nk_static, 2, None) + ctx.ks).astype(dtype)
        raise TypeError(type(expr).__name__)
