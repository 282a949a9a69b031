"""Embedded field implementation on JAX arrays.

Counterpart of the reference's ``gt4py.next.embedded`` +
``nd_array_field.py`` (NumPy/CuPy/JAX fields,
/root/reference/src/gt4py/next/embedded/nd_array_field.py:136,1062).
Differences by design:

- JAX is the *only* array backend (the reference's ``JaxArrayField`` is a
  secondary backend there; here it is the implementation),
- ``Field`` is a registered pytree, so whole field-operator calls compile
  under ``jax.jit`` — embedded execution is simultaneously the semantic
  oracle and a fast path (the reference's embedded path is eager
  NumPy and is orders of magnitude slower than its compiled backends),
- domain alignment (intersection) and dim promotion happen at trace time
  (Python), producing pure jnp ops for XLA to fuse.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import numpy as np

from gt4py_tpu.next.common import (
    Connectivity,
    Dimension,
    Domain,
    FieldOffset,
    NamedRange,
    OffsetIndex,
    UnitRange,
)

# offset_provider for the current field-operator call (reference:
# embedded/context.py).
_OFFSET_PROVIDER: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "offset_provider", default=None
)


def current_offset_provider() -> dict:
    value = _OFFSET_PROVIDER.get()
    if value is None:
        raise RuntimeError(
            "No offset_provider in context — pass offset_provider={...} to the "
            "field operator / program call"
        )
    return value


class offset_provider_context:
    def __init__(self, provider: Optional[dict]):
        # None inherits the ambient provider: an operator called inside a
        # program (or another operator) without its own offset_provider
        # keeps the program's (reference: offset_provider flows through
        # the whole program call). An explicit {} still clears.
        if provider is None:
            provider = _OFFSET_PROVIDER.get() or {}
        self.provider = provider

    def __enter__(self):
        self._token = _OFFSET_PROVIDER.set(self.provider)
        return self

    def __exit__(self, *args):
        _OFFSET_PROVIDER.reset(self._token)
        return False


def _promote_dims(a: tuple[Dimension, ...], b: tuple[Dimension, ...]) -> tuple[Dimension, ...]:
    """Union of dims preserving relative order (reference common.py:1367)."""
    result = list(a)
    for d in b:
        if d not in result:
            # Insert respecting b's order relative to dims already present.
            later = [x for x in b[b.index(d) + 1:] if x in result]
            if later:
                idx = min(result.index(x) for x in later)
                result.insert(idx, d)
            else:
                result.append(d)
    return tuple(result)


def _xp(arr):
    """Array namespace of a backing array. NumPy-backed fields stay in
    NumPy end-to-end — that is the independent ORACLE mode (reference
    "roundtrip"/embedded NumPy backend, nd_array_field.py:136's
    NumPyArrayField): results never route through XLA, so the jax path
    can be validated against genuinely foreign arithmetic."""
    if isinstance(arr, (np.ndarray, np.generic)):
        return np
    import jax.numpy as jnp

    return jnp


def _iota(xp, shape, axis, dtype=np.int32):
    from gt4py_tpu.core.ndarray_utils import broadcast_iota

    return broadcast_iota(xp, shape, axis, dtype)


_MAX_SHIFT_CLASSES = 8
# Mostly-structured columns: rows outside the top shift classes (mesh
# boundaries, local refinements, hand-patched entries) are fixed up by a
# sparse row-gather + scatter after the rolls. The fix-up costs ~2x the
# per-row gather rate for the RESIDUAL rows only, so it wins as long as
# the residual is a small fraction of the column.
_MAX_RESIDUAL_FRAC = 0.15


def _host_table(conn):
    """Host (numpy) snapshot of ``conn.table``, cached on the connectivity.

    Plan analysis must read the table on the host. ``conn.table`` is
    normally a concrete device array, but slicing it while a jit trace
    is ACTIVE stages the slice and returns a tracer — ``np.asarray`` on
    the whole concrete array, by contrast, is a plain host conversion
    that works under trace too. Returns None only when the table itself
    is a tracer (connectivity built inside a jit).

    Note: the snapshot is retained on the connectivity for its lifetime —
    one host copy per table, traded for never re-transferring during plan
    analysis. Real conversion errors propagate; only JAX tracer-conversion
    errors mean "no host view available"."""
    host = getattr(conn, "_host_table", None)
    if host is None:
        import jax.errors

        try:
            host = np.asarray(conn.table)
        except (
            jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError,
        ):
            return None
        conn._host_table = host
    return host


class _ShiftPlan(NamedTuple):
    diffs: np.ndarray  # int32 cyclic-shift classes (at most _MAX_SHIFT_CLASSES)
    sel: np.ndarray  # int8 per-row class label; residual rows hold 0
    res_rows: Optional[np.ndarray]  # int32 rows served by the fix-up gather
    res_idx: Optional[np.ndarray]  # int32 pre-clamped targets for those rows


def _shift_plan(conn, column: int, own_start: int, n: int):
    """Detect roll-structure in one connectivity column: when
    ``(table[:, j] - start - arange) mod n`` takes at most
    ``_MAX_SHIFT_CLASSES`` distinct values over MOST rows, the gather
    ``x[table[r, j]]`` equals a masked select over K cyclic shifts of
    ``x`` — pure slice/concat traffic instead of per-row gathers
    (structured and block-structured meshes, e.g. the periodic quad
    mesh, have K ≤ 3 per column). Rows outside the top classes (up to
    ``_MAX_RESIDUAL_FRAC`` of the column — mesh boundaries, refinement
    patches, out-of-range neighbors) are recorded for a sparse
    row-gather fix-up. Returns a ``_ShiftPlan`` or None for genuinely
    irregular columns. Cached on the connectivity (tables are
    immutable)."""
    cache = getattr(conn, "_shift_plans", None)
    if cache is None:
        cache = conn._shift_plans = {}
    key = (column, own_start, n)
    if key in cache:
        return cache[key]
    host = _host_table(conn)
    if host is None:
        # Genuinely traced table (connectivity BUILT inside a jit, so no
        # concrete values exist) — unanalyzable right now, but do NOT
        # cache the failure: the same connectivity may later be planned
        # eagerly. Crucially, slicing a CONCRETE table under an active
        # trace stages the op and yields a tracer, so all host analysis
        # must go through _host_table, never conn.table[...].
        return None
    t = host[:, column].astype(np.int64) - own_start
    valid = np.ones(t.shape, dtype=bool)
    if conn.skip_value is not None:
        valid = host[:, column] != conn.skip_value
    plan = None
    if n > 0:
        # Out-of-range neighbors clamp in the fallback; a cyclic shift
        # would wrap them instead — such rows can only be served by the
        # clamped fix-up gather, never by a roll.
        in_range = (t >= 0) & (t < n)
        core = valid & in_range
        d = (np.clip(t, 0, n - 1) - (np.arange(t.shape[0]) % n)) % n
        if core.any():
            vals, counts = np.unique(d[core], return_counts=True)
        else:
            vals, counts = np.zeros(1, np.int64), np.ones(1, np.int64)
        # Count-aware class selection: each kept class costs one full
        # roll + tile + masked select over all n_src rows, while the
        # fix-up gather serves a row at ~2x the per-row gather rate PLUS
        # a scatter back into the result. Near-singleton classes
        # (rewired rows, hand-patched entries) must not each pay a
        # whole-field pass — route them to the residual gather. The
        # threshold is deliberately SOFT (n_src/4096, floor 2): genuine
        # mesh-structure classes (periodic wraps, block boundaries)
        # serve ~n_src/n rows and must stay rolls (what demoting the wrap
        # class of the periodic quad mesh to the residual costs on the GPU
        # is not measured). The largest
        # class is always kept so the plan has a base shift; if even it
        # is tiny, the residual-fraction check below rejects the plan
        # entirely.
        order = np.argsort(counts)[::-1]
        min_count = max(2, t.shape[0] // 4096)
        keep = [order[0]] + [
            int(k) for k in order[1 : _MAX_SHIFT_CLASSES] if counts[k] >= min_count
        ]
        vals = vals[np.sort(np.asarray(keep, dtype=np.int64))]
        covered = core & np.isin(d, vals)
        residual = valid & ~covered
        n_valid = int(valid.sum())
        if n_valid == 0 or residual.sum() <= _MAX_RESIDUAL_FRAC * n_valid:
            sel = np.zeros(t.shape[0], dtype=np.int8)
            for k, v in enumerate(vals):
                sel[(d == v) & covered] = k
            res_rows = res_idx = None
            if residual.any():
                res_rows = np.nonzero(residual)[0].astype(np.int32)
                res_idx = np.clip(t[residual], 0, n - 1).astype(np.int32)
            plan = _ShiftPlan(vals.astype(np.int32), sel, res_rows, res_idx)
    cache[key] = plan
    return plan


class _RollTile(NamedTuple):
    tile_len: int  # target rows served by this tile
    base: int  # source window start
    L: int  # source window length (== reshape size Q*P)
    P: int  # minor period (P == L -> plain 1-axis roll)
    a: int  # outer roll amount (rows of the (Q, P) view)
    s: int  # minor roll amount


class _RollPlan(NamedTuple):
    tiles: tuple  # of _RollTile, covering the target rows in order
    res_rows: Optional[np.ndarray]  # rows served by the fix-up gather
    res_idx: Optional[np.ndarray]  # pre-clamped source targets for them


_MAX_ROLL_DIVISORS = 64


def _divisors_desc(L: int) -> list:
    """Divisors of L in descending order (bounded)."""
    small = []
    large = []
    d = 1
    while d * d <= L:
        if L % d == 0:
            small.append(d)
            if d != L // d:
                large.append(L // d)
        d += 1
    out = large + small[::-1]
    return out[:_MAX_ROLL_DIVISORS]


def _roll_plan(conn, column: int, own_start: int, n: int):
    """Detect that one connectivity column is a cyclic ROLL of a source
    window — possibly a 2-axis roll of its ``(Q, P)`` view (structured
    meshes flattened from 2-D grids: a j-neighbor is a minor-axis roll
    with period P = row length). One roll replaces the class plan's K
    rolls + masked selects: the HLO is a pure slice/concat chain with no
    select masks, which XLA fuses end-to-end.

    Search: per target tile, the candidate minor periods are the
    divisors of the window length; for each P the per-row key
    ``((u_src-u) mod Q)*P + ((v_src-v) mod P)`` is constant exactly on
    rows served by a 2-axis roll, so the mode of the key gives the roll
    and the off-mode rows the residual (mesh boundaries, rewires —
    served by the same sparse fix-up gather as the class plan). The
    plan with the fewest residual rows wins. Returns None when any tile
    has no roll serving ``1 - _MAX_RESIDUAL_FRAC`` of its rows (the
    class plan then handles genuinely multi-class columns).
    Cached on the connectivity (tables are immutable)."""
    cache = getattr(conn, "_roll_plans", None)
    if cache is None:
        cache = conn._roll_plans = {}
    key = (column, own_start, n)
    if key in cache:
        return cache[key]
    host = _host_table(conn)
    if host is None:
        return None  # traced table: do not cache (see _shift_plan)
    plan = None
    if n > 0:
        t = host[:, column].astype(np.int64) - own_start
        valid = np.ones(t.shape, dtype=bool)
        if conn.skip_value is not None:
            valid = host[:, column] != conn.skip_value
        in_range = (t >= 0) & (t < n)
        core_all = valid & in_range
        n_src = t.shape[0]
        tiles = []
        residual = np.zeros(n_src, dtype=bool)
        ok = True
        for start in range(0, n_src, n):
            stop = min(start + n, n_src)
            tile_len = stop - start
            tt = t[start:stop]
            core = core_all[start:stop]
            if not core.any():
                tiles.append(_RollTile(tile_len, 0, min(tile_len, n), min(tile_len, n), 0, 0))
                residual[start:stop] |= valid[start:stop]
                continue
            min_t = int(tt[core].min())
            max_t = int(tt[core].max())
            if max_t - min_t < tile_len <= n:
                base = min(min_t, n - tile_len)
                L = tile_len
            elif tile_len == n:
                base = 0
                L = n
            elif tile_len < n:
                # Outlier targets (rewired rows) can blow the min/max span
                # past the window length — center the window on the BULK
                # (median) instead; rows outside it drop out of `core`
                # below and are served by the residual fix-up.
                med = int(np.median(tt[core]))
                base = int(np.clip(med - tile_len // 2, 0, n - tile_len))
                L = tile_len
            else:
                ok = False
                break
            p = np.arange(tile_len, dtype=np.int64)
            src_rel = np.clip(tt - base, 0, L - 1)
            core = core & (tt - base >= 0) & (tt - base < L)
            best = None  # (res_count, P, a, s, served)
            for P in _divisors_desc(L):
                Q = L // P
                u, v = np.divmod(p, P)
                us, vs = np.divmod(src_rel, P)
                k = ((us - u) % Q) * P + ((vs - v) % P)
                counts = np.bincount(k[core], minlength=1)
                mode = int(counts.argmax())
                served = core & (k == mode)
                res = int(valid[start:stop].sum() - served.sum())
                if best is None or res < best[0]:
                    best = (res, P, mode // P, mode % P, served)
                    if res == 0:
                        break
            n_valid = int(valid[start:stop].sum())
            if n_valid and best[0] > _MAX_RESIDUAL_FRAC * n_valid:
                ok = False
                break
            _, P, a, s, served = best
            tiles.append(_RollTile(tile_len, base, L, P, a, s))
            residual[start:stop] |= valid[start:stop] & ~served
        if ok:
            res_rows = res_idx = None
            if residual.any():
                res_rows = np.nonzero(residual)[0].astype(np.int32)
                res_idx = np.clip(t[residual], 0, n - 1).astype(np.int32)
            plan = _RollPlan(tuple(tiles), res_rows, res_idx)
    cache[key] = plan
    return plan


def _roll_gather_1d(x, plan: _RollPlan, apply_fixup: bool = True):
    """Execute a roll plan: per tile, slice the source window, roll its
    ``(Q, P)`` view by ``(-a, -s)``, flatten, and truncate to the tile;
    concatenate tiles; then the sparse residual fix-up (same semantics
    as the class plan's). Works for trailing data axes (whole-row
    rolls)."""
    import jax.numpy as jnp

    outs = []
    for tile in plan.tiles:
        w = x[tile.base : tile.base + tile.L]
        if tile.P == tile.L:
            r = jnp.roll(w, -(tile.a * tile.P + tile.s) % tile.L, axis=0) if (
                tile.a or tile.s
            ) else w
        else:
            Q = tile.L // tile.P
            w2 = w.reshape((Q, tile.P) + w.shape[1:])
            r = jnp.roll(w2, (-tile.a, -tile.s), axis=(0, 1)).reshape(
                (tile.L,) + w.shape[1:]
            )
        outs.append(r[: tile.tile_len])
    out = jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
    if plan.res_rows is not None and apply_fixup:
        if x.ndim == 1:
            fix = _rowgather_1d(x, jnp.asarray(plan.res_idx))
        else:
            fix = jnp.take(x, jnp.asarray(plan.res_idx), axis=0)
        out = out.at[jnp.asarray(plan.res_rows)].set(
            fix, unique_indices=True, indices_are_sorted=True
        )
    return out


def _shift_gather_1d(x, conn, column: int, own_start: int, apply_fixup: bool = True):
    """Gather ``x[table[:, column] - own_start]`` along axis 0 via the
    shift plan: K rolls (tiled to the source length) + masked selects,
    then a sparse row-gather + scatter fix-up for the plan's residual
    rows (clamped, matching the general-gather fallback semantics).

    ``x`` may carry trailing data axes (ICON-style ``(Cell, K)`` fields):
    rolls/selects/fix-ups all act on whole rows, so the decomposition
    stays streaming-bound for them too.

    ``apply_fixup=False`` skips the residual fix-up (the multi-column
    remap path batches all columns' fix-ups into one gather + one
    scatter instead — each isolated small gather/scatter pays a fixed op
    cost, so a 4-column table saves ~6 ops per step; the cost on the GPU is
    not measured)."""
    import jax.numpy as jnp

    n = x.shape[0]
    rplan = _roll_plan(conn, column, own_start, n)
    if rplan is not None:
        return _roll_gather_1d(x, rplan, apply_fixup=apply_fixup)
    plan = _shift_plan(conn, column, own_start, n)
    if plan is None:
        return None
    diffs, sel = plan.diffs, plan.sel
    n_src = sel.shape[0]
    m = -(-n_src // n)
    sel_dev = jnp.asarray(sel).reshape((n_src,) + (1,) * (x.ndim - 1))

    def shifted(d):
        r = jnp.roll(x, -int(d), axis=0)
        if m > 1 or n_src != n:
            reps = (m,) + (1,) * (x.ndim - 1)
            r = jnp.tile(r, reps)[:n_src] if m > 1 else r[:n_src]
        return r

    out = shifted(diffs[0])
    for k in range(1, len(diffs)):
        out = jnp.where(sel_dev == k, shifted(diffs[k]), out)
    if plan.res_rows is not None and apply_fixup:
        if x.ndim == 1:
            fix = _rowgather_1d(x, jnp.asarray(plan.res_idx))
        else:
            # whole-row gather runs at the per-row ceiling already
            fix = jnp.take(x, jnp.asarray(plan.res_idx), axis=0)
        # res_rows comes from np.nonzero -> sorted and unique by
        # construction; the hints let XLA skip the scatter's dedup sort.
        out = out.at[jnp.asarray(plan.res_rows)].set(
            fix, unique_indices=True, indices_are_sorted=True
        )
    return out


def _batched_residual(conn, own_start: int, n: int):
    """Combine the residual fix-up GATHERS of all columns of ``conn``
    into one concatenated source-index array, so a multi-column remap
    pays ONE fix gather from the source field instead of one per column
    (an isolated small gather pays a fixed cost far above its per-element
    rate). The SCATTERS merge too: the fixed-up parts concatenate along
    axis 0 and ONE scatter at flattened ``seg*n_src + res_rows`` offsets
    serves every column, with slices recovering the per-column parts (the
    GPU times of both forms are not measured). Returns
    ``(src_idx, flat_rows, segments)``
    with ``segments`` a list of ``(column, start, stop)`` slices into
    the gather result, or None when no column has residual rows.
    Cached on the connectivity (tables are immutable)."""
    cache = getattr(conn, "_batched_residuals", None)
    if cache is None:
        cache = conn._batched_residuals = {}
    key = (own_start, n)
    if key in cache:
        return cache[key]
    ncols = conn.table.shape[1]
    n_src = conn.table.shape[0]
    idx_parts = []
    row_parts = []
    segments = []
    pos = 0
    for c in range(ncols):
        # The residuals of whichever plan serves the column (roll plan
        # takes precedence in _shift_gather_1d).
        plan = _roll_plan(conn, c, own_start, n) or _shift_plan(
            conn, c, own_start, n
        )
        if plan is not None and plan.res_rows is not None:
            m = plan.res_rows.shape[0]
            idx_parts.append(plan.res_idx)
            # Offset by the segment's slot in the concatenated parts
            # array: blocks are disjoint and each column's rows are
            # sorted/unique (np.nonzero), so the flat indices stay
            # globally sorted and unique — XLA skips the dedup sort.
            row_parts.append(
                plan.res_rows.astype(np.int64) + len(segments) * n_src
            )
            segments.append((c, pos, pos + m))
            pos += m
    if not idx_parts:
        cache[key] = None
        return None
    flat_rows = np.concatenate(row_parts)
    if flat_rows[-1] <= np.iinfo(np.int32).max:
        flat_rows = flat_rows.astype(np.int32)
    combined = (np.concatenate(idx_parts), flat_rows, segments)
    cache[key] = combined
    return combined


def _apply_batched_fixup(parts, x, conn, own_start: int):
    """Apply the combined residual fix-up to the per-column gather
    parts (each ``(n_src, *rest)``, BEFORE stacking): one concatenated
    row gather from ``x``, then ONE scatter into the axis-0
    concatenation of the fixed-up columns' parts (sliced back apart
    afterwards — one scatter instead of one per column). Returns the
    updated parts list."""
    import jax.numpy as jnp

    combined = _batched_residual(conn, own_start, x.shape[0])
    if combined is None:
        return parts
    src_idx, flat_rows, segments = combined
    if x.ndim == 1:
        fix = _rowgather_1d(x, jnp.asarray(src_idx))
    else:
        fix = jnp.take(x, jnp.asarray(src_idx), axis=0)
    parts = list(parts)
    if len(segments) == 1:
        c, start, stop = segments[0]
        parts[c] = parts[c].at[jnp.asarray(flat_rows)].set(
            fix, unique_indices=True, indices_are_sorted=True
        )
        return parts
    n_src = parts[segments[0][0]].shape[0]
    cat = jnp.concatenate([parts[c] for c, _, _ in segments], axis=0)
    cat = cat.at[jnp.asarray(flat_rows)].set(
        fix, unique_indices=True, indices_are_sorted=True
    )
    for k, (c, _, _) in enumerate(segments):
        parts[c] = cat[k * n_src : (k + 1) * n_src]
    return parts


def _propagate_parts(out, lhs, a, rhs, b, dims, dom, op):
    """Column-wise propagation of lazy neighbor parts through an
    elementwise Field-Field op (no masks — the caller gates on that).

    A remap result carries its per-column gather parts alongside the
    stacked array (``_neighbor_parts``). When an operand's full shape
    survives alignment unchanged (result dims == its dims, result ranges
    == its ranges), each part pairs with the OTHER operand's aligned
    array sliced at that neighbor index: op(part_c, b[..., c, ...]).
    The slice of a broadcast-aligned array fuses away under XLA, so the
    weighted-neighbor pattern ``remap * weights`` stays unstacked all
    the way into the reduction."""
    lp = getattr(lhs, "_neighbor_parts", None)
    rp = getattr(rhs, "_neighbor_parts", None)
    if lp is None and rp is None:
        return

    def intact(f, arr):
        return (
            dims == f.dims
            and dom.ranges == f.domain.ranges
            and tuple(arr.shape) == tuple(f.ndarray.shape)
        )

    def take_c(arr, ax, c):
        return arr[(slice(None),) * ax + (c,)]

    if lp is not None and rp is not None:
        nd = lp[0]
        if (
            rp[0] == nd
            and len(lp[1]) == len(rp[1])
            and intact(lhs, a)
            and intact(rhs, b)
        ):
            out._neighbor_parts = (
                nd,
                tuple(op(p, q) for p, q in zip(lp[1], rp[1])),
            )
        return
    if lp is not None:
        nd, parts = lp
        if nd in dom and intact(lhs, a):
            ax = dims.index(nd)
            if len(parts) == out.ndarray.shape[ax]:
                out._neighbor_parts = (
                    nd,
                    tuple(op(p, take_c(b, ax, c)) for c, p in enumerate(parts)),
                )
        return
    nd, parts = rp
    if nd in dom and intact(rhs, b):
        ax = dims.index(nd)
        if len(parts) == out.ndarray.shape[ax]:
            out._neighbor_parts = (
                nd,
                tuple(op(take_c(a, ax, c), p) for c, p in enumerate(parts)),
            )


def _rowgather_1d(x, idx):
    """Unstructured 1-D gather as a row gather + in-row mask-select.

    Gathers 8-wide ROWS and selects the lane with an iota mask instead of
    gathering single elements (the FVM-nabla hot path). Whether this beats
    XLA's plain element gather on the GPU is not measured (ROADMAP Speed
    5). ``idx`` must be pre-clamped int32; any shape (result keeps it).

    Multi-dim fields (e.g. ICON-style (Cell, K) columns) do NOT need
    this: ``take`` along axis 0 already gathers whole rows."""
    import jax.numpy as jnp
    from jax import lax

    W = 8
    n = x.shape[0]
    npad = -(-n // W) * W
    if npad != n:
        x = jnp.pad(x, (0, npad - n), mode="edge")
    flat = idx.reshape(-1)
    rows = jnp.take(x.reshape(npad // W, W), flat // W, axis=0, mode="clip")
    mask = (flat % W)[:, None] == lax.broadcasted_iota(jnp.int32, (1, W), 1)
    out = jnp.sum(jnp.where(mask, rows, jnp.zeros((), x.dtype)), axis=1)
    return out.reshape(idx.shape)


@dataclasses.dataclass
class Field:
    """Discrete field over a Domain, backed by a jnp array (one axis per
    domain dimension). Supports arithmetic, comparison, shifts via
    ``field(offset)``, and reductions via fbuiltins."""

    domain: Domain
    ndarray: Any
    # Validity mask for gathered neighbor values (skip_value handling);
    # None = all valid. Same shape as ndarray.
    mask: Any = None
    # View write-back link: ``(parent_field, index_tuple)`` set by
    # restriction so ``out=field[:, 1:]`` (reference relative-slicing
    # out-arg idiom, test_icon_like_scan.py:79) propagates writes to the
    # base field. The reference gets this for free from mutable ndarray
    # views; our fields rebind immutable jax arrays, so the link is
    # explicit. Writes flow view -> base only (views snapshot the base at
    # restriction time). Not part of the pytree (eager write-back only).
    base: Any = None

    # Opt out of NumPy ufunc dispatch: ``np.float64(x) <= field`` must
    # defer to the reflected Field operator (mask field), not attempt
    # element-wise broadcasting over the Field object (which ends in the
    # __bool__ guard). Reference embedded fields inherit the same via
    # NDArrayObject interop.
    __array_ufunc__ = None

    def __post_init__(self):
        expected = tuple(
            1 if not r.unit_range.is_finite else len(r.unit_range)
            for r in self.domain.ranges
        )
        if tuple(self.ndarray.shape) != expected:
            raise ValueError(
                f"Array shape {tuple(self.ndarray.shape)} does not match domain "
                f"{self.domain} shape {expected}"
            )

    # Annotation syntax: ``Field[Dims[I, J], float]`` yields a
    # :class:`gt4py_tpu.next.type_system.FieldType` spec usable as a DSL
    # parameter/return annotation (reference common.py Field generic,
    # consumed by ffront type deduction).
    def __class_getitem__(cls, item):
        from gt4py_tpu.next.type_system import FieldType

        if not (isinstance(item, tuple) and len(item) == 2):
            raise TypeError(
                "Field[...] annotations take two arguments: Field[Dims[...], dtype]"
            )
        dims, dtype = item
        if isinstance(dims, Dimension):
            dims = (dims,)
        if not (
            isinstance(dims, tuple) and all(isinstance(d, Dimension) for d in dims)
        ):
            raise TypeError(f"Field[...] expects Dims[...] first, got {dims!r}")
        return FieldType(dims=tuple(dims), dtype=np.dtype(dtype))

    # -- interface ---------------------------------------------------------

    @property
    def dtype(self):
        return np.dtype(self.ndarray.dtype)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.ndarray.shape)

    @property
    def dims(self) -> tuple[Dimension, ...]:
        return self.domain.dims

    def asnumpy(self) -> np.ndarray:
        return np.asarray(self.ndarray)

    def as_scalar(self):
        if self.domain.ndim != 0:
            raise ValueError("as_scalar requires a zero-dimensional field")
        return self.ndarray[()]

    # -- shifts ------------------------------------------------------------

    def __call__(
        self,
        offset: Union[OffsetIndex, FieldOffset, "Connectivity"],
        *more: Union[OffsetIndex, FieldOffset, "Connectivity"],
    ) -> "Field":
        """Shift/remap (reference NdArrayField.premap, nd_array_field.py:240).
        Multiple offsets fold left-to-right (reference __call__:369)."""
        if more:
            result = self(offset)
            for o in more:
                result = result(o)
            return result
        if isinstance(offset, OffsetIndex):
            provider = _OFFSET_PROVIDER.get()
            mapped = (provider or {}).get(offset.offset.value)
            if isinstance(mapped, Connectivity) or hasattr(
                mapped, "sharded_gather"
            ):
                # Partial shift: gather only the index-th neighbor column
                # (halves the gather volume vs remap-then-select).
                return self._remap_connectivity(mapped, column=offset.index)
            fo = offset.offset
            is_cartesian = isinstance(mapped, Dimension) or (
                mapped is None and fo.target == (fo.source,)
            )
            if not is_cartesian:
                raise RuntimeError(
                    f"Offset '{fo.value}' is unstructured; pass its Connectivity "
                    "via offset_provider"
                )
            return self._shift_cartesian(fo.source, offset.index)
        if isinstance(offset, FieldOffset):
            provider = _OFFSET_PROVIDER.get()
            mapped = (provider or {}).get(offset.value)
            if mapped is None:
                raise RuntimeError(
                    f"Offset '{offset.value}' not found in offset_provider"
                )
            if isinstance(mapped, Dimension):
                raise ValueError(
                    f"Cartesian offset '{offset.value}' requires an index: use "
                    f"{offset.value}[n]"
                )
            return self._remap_connectivity(mapped)
        if isinstance(offset, Connectivity):
            return self._remap_connectivity(offset)
        from gt4py_tpu.next.common import CartesianConnectivity

        if isinstance(offset, CartesianConnectivity):
            if offset.codomain == offset.dim:
                return self._shift_cartesian(offset.dim, offset.offset)
            # Staggered premap (reference _domain_premap): the field lives
            # on ``codomain``; the result lives on ``dim`` with
            # result(i) = field(codomain(i + offset)).
            if offset.codomain not in self.domain:
                raise ValueError(
                    f"Cannot premap: field over {self.domain} has no "
                    f"{offset.codomain.value} dimension (needed by {offset!r})"
                )
            nr = self.domain[offset.codomain]
            new_range = NamedRange(offset.dim, nr.unit_range.shifted(-offset.offset))
            return Field(
                self.domain.replace(offset.codomain, new_range), self.ndarray, self.mask
            )
        from gt4py_tpu.next.experimental import AsOffset

        if isinstance(offset, AsOffset):
            return self._shift_dynamic(offset.offset.source, offset.index_field)
        raise TypeError(f"Cannot shift by {offset!r}")

    def premap(self, offset) -> "Field":
        """Reference-name alias for shifting/remapping
        (NdArrayField.premap, nd_array_field.py:240)."""
        return self(offset)

    def restrict(self, domain_spec) -> "Field":
        """Restrict to a sub-domain (reference NdArrayField.restrict,
        nd_array_field.py:378)."""
        from gt4py_tpu.next.common import domain as make_domain

        target = make_domain(domain_spec)
        slices = []
        new_ranges = []
        for nr in self.domain.ranges:
            if nr.dim in target:
                tr = target[nr.dim].unit_range
                own = nr.unit_range
                if tr.start < own.start or tr.stop > own.stop:
                    raise ValueError(
                        f"restriction {tr} outside field range {own} for {nr.dim}"
                    )
                slices.append(slice(tr.start - own.start, tr.stop - own.start))
                new_ranges.append(NamedRange(nr.dim, tr))
            else:
                slices.append(slice(None))
                new_ranges.append(nr)
        arr = self.ndarray[tuple(slices)]
        mask = self.mask[tuple(slices)] if self.mask is not None else None
        return Field(Domain(tuple(new_ranges)), arr, mask, base=(self, tuple(slices)))

    def _rebind(self, new_array: Any) -> None:
        """Replace the backing array, writing through to the base field when
        this field is a restriction view (out-arg write-back path)."""
        self.ndarray = new_array
        if self.base is not None:
            parent, sl = self.base
            buf = parent.ndarray
            if isinstance(buf, np.ndarray):
                buf = buf.copy()
                buf[sl] = np.asarray(new_array)
            else:
                import jax.numpy as jnp

                buf = jnp.asarray(buf).at[sl].set(new_array)
            parent._rebind(buf)

    def _restrict_relative(self, index: tuple) -> Any:
        """Relative (positional) indexing: tuples of slices / ints /
        Ellipsis over the domain dims in order (reference
        embedded/common.py:33 ``_relative_sub_domain``). Slices narrow the
        unit range in place; ints collapse the dimension. Negative values
        count from the range stop. Step slicing is rejected."""
        n = self.domain.ndim
        if sum(1 for e in index if e is Ellipsis) > 1:
            raise IndexError("an index can only have a single Ellipsis")
        if Ellipsis in index:
            at = index.index(Ellipsis)
            fill = n - (len(index) - 1)
            if fill < 0:
                raise IndexError(
                    f"too many indices for field with {n} dimensions: {index!r}"
                )
            index = index[:at] + (slice(None),) * fill + index[at + 1 :]
        if len(index) > n:
            raise IndexError(
                f"too many indices for field with {n} dimensions: {index!r}"
            )
        index = index + (slice(None),) * (n - len(index))
        ranges: list = []
        arr_index: list = []
        for nr, idx in zip(self.domain.ranges, index):
            rng = nr.unit_range
            if isinstance(idx, slice):
                if idx.step not in (None, 1):
                    raise IndexError("field slicing does not support a step")
                if not rng.is_finite:
                    if idx != slice(None):
                        raise IndexError(
                            f"cannot slice unbounded dimension {nr.dim}"
                        )
                    arr_index.append(slice(None))
                    ranges.append(nr)
                    continue
                lo, hi, _ = idx.indices(len(rng))
                hi = max(hi, lo)
                arr_index.append(slice(lo, hi))
                ranges.append(
                    NamedRange(nr.dim, UnitRange(rng.start + lo, rng.start + hi))
                )
            else:
                i = int(idx)
                if not rng.is_finite:
                    raise IndexError(f"cannot index unbounded dimension {nr.dim}")
                pos = i if i >= 0 else len(rng) + i
                if pos < 0 or pos >= len(rng):
                    raise IndexError(
                        f"index {i} out of range {rng} for {nr.dim}"
                    )
                arr_index.append(pos)
        result = Field(
            Domain(tuple(ranges)),
            self.ndarray[tuple(arr_index)],
            self.mask[tuple(arr_index)] if self.mask is not None else None,
            base=(self, tuple(arr_index)),
        )
        if result.domain.ndim == 0:
            return result.as_scalar()
        return result

    def _shift_dynamic(self, dim: Dimension, idx: "Field") -> "Field":
        """Per-point variable shift along ``dim`` (reference experimental
        ``as_offset``, ffront/experimental.py:17): out(p) = self(p + idx(p)
        along dim). The gather reads self's FULL extent along ``dim`` —
        offsets may reach halo points beyond the output domain (reference
        test_cartesian_shifts.py test_offset_field reads a at I+1 on the
        last output row). Out-of-range positions clamp to the field
        boundary."""
        xp = _xp(self.ndarray)

        dims = _promote_dims(self.dims, idx.dims)
        if dim not in dims or dim not in self.domain:
            raise ValueError(f"as_offset dimension {dim} not present")
        dom, _ = self._aligned(dims, idx)
        _, b = idx._aligned(dims, self)
        # source array: cropped to the output domain on every dim EXCEPT
        # the shifted one, kept full along it
        wide_probe = object.__new__(Field)
        wide_probe.domain = dom.replace(
            dim, NamedRange(dim, self.domain[dim].unit_range)
        )
        wide_probe.ndarray = self.ndarray
        wide_probe.mask = None
        _, a_wide = self._aligned(dims, wide_probe)
        axis = dom.dims.index(dim)
        n = a_wide.shape[axis]
        # output position i sits at (dom_start - self_start) + i in the
        # wide source array
        off0 = (
            dom[dim].unit_range.start - self.domain[dim].unit_range.start
        )
        shape = tuple(
            1 if not r.unit_range.is_finite else len(r.unit_range)
            for r in dom.ranges
        )
        base = _iota(xp, shape, axis) + off0
        pos = xp.clip(base + b.astype(np.int32), 0, n - 1)
        # take_along_axis broadcasts index vs array on non-axis dims
        out = xp.take_along_axis(a_wide, pos, axis=axis)
        return Field(dom, out)

    def _shift_cartesian(self, dim: Dimension, index: int) -> "Field":
        """out(i) = self(i + index)  ⇔ domain range shifted by -index."""
        nr = self.domain[dim]
        new_range = NamedRange(dim, nr.unit_range.shifted(-index))
        return Field(self.domain.replace(dim, new_range), self.ndarray, self.mask)

    def _remap_connectivity(
        self, conn: Connectivity, column: Optional[int] = None
    ) -> "Field":
        xp = _xp(self.ndarray)

        if self.domain.ndim == 0 or conn.codomain not in self.domain:
            raise ValueError(
                f"Field over {self.domain} cannot be remapped via {conn!r}"
            )
        axis = self.domain.index(conn.codomain)
        table = conn.table if column is None else conn.table[:, column]
        own_start = self.domain[conn.codomain].unit_range.start
        idx = table - own_start
        lazy_parts = None
        # int32 indices + pre-clamped 'clip' mode: 1-D gathers without x64
        # index math and out-of-bounds fill selects (FVM-nabla hot path).
        if hasattr(conn, "sharded_gather"):
            # Distributed explicit-ghost connectivity (parallel/
            # unstructured.DistributedUnstructured): the gather runs
            # inside shard_map as ppermute halo slabs + a local gather.
            if axis != 0:
                raise ValueError(
                    "sharded gathers require the codomain dimension first"
                )
            gathered = conn.sharded_gather(self.ndarray, column)
        elif xp is np:
            safe_idx = np.clip(np.asarray(idx), 0, self.ndarray.shape[axis] - 1)
            gathered = np.take(self.ndarray, safe_idx, axis=axis)
        else:
            gathered = None
            if axis == 0 and self.ndarray.dtype != np.bool_:
                # Structured-connectivity fast path: columns with few
                # distinct (target - source) shift classes lower to rolls +
                # masked selects (bandwidth-bound, where a row gather is
                # bound by its per-row rate). Fields with
                # trailing data axes (e.g. (Cell, K)) roll whole rows.
                cols = [column] if column is not None else list(
                    range(conn.table.shape[1])
                )
                multi = column is None and len(cols) > 1
                parts = []
                for c in cols:
                    part = _shift_gather_1d(
                        self.ndarray, conn, c, int(own_start),
                        apply_fixup=not multi,
                    )
                    if part is None:
                        parts = None
                        break
                    parts.append(part)
                if parts is not None:
                    # neighbor axis sits right after source (see the axes
                    # note below); equals axis=-1 only for 1-D fields
                    if column is not None:
                        gathered = parts[0]
                    else:
                        if multi:
                            parts = _apply_batched_fixup(
                                parts, self.ndarray, conn, int(own_start)
                            )
                        gathered = xp.stack(parts, axis=1)
                        lazy_parts = tuple(parts)
            if gathered is None:
                safe_idx = xp.clip(
                    idx.astype(np.int32), 0, self.ndarray.shape[axis] - 1
                )
                if self.ndarray.ndim == 1 and self.ndarray.dtype != np.bool_:
                    gathered = _rowgather_1d(self.ndarray, safe_idx)
                else:
                    gathered = xp.take(
                        self.ndarray, safe_idx, axis=axis, mode="clip"
                    )
        # gathered axes: dims[:axis] + (source[, neighbor]) + dims[axis+1:]
        neighbor_ranges = (
            (NamedRange(conn.neighbor_dim, UnitRange(0, conn.table.shape[1])),)
            if column is None
            else ()
        )
        new_ranges = (
            self.domain.ranges[:axis]
            + (NamedRange(conn.source_dim, UnitRange(0, conn.table.shape[0])),)
            + neighbor_ranges
            + self.domain.ranges[axis + 1:]
        )
        mask = None
        if conn.skip_value is not None:
            valid = (table != conn.skip_value).reshape(
                (1,) * axis + table.shape + (1,) * (self.ndarray.ndim - axis - 1)
            )
            mask = xp.broadcast_to(np.asarray(valid) if xp is np else valid, gathered.shape)
        # Move the (source, neighbor) axes to the front (reference puts the
        # new source dim where the codomain dim was; keep in place).
        result = Field(Domain(new_ranges), gathered, mask)
        if lazy_parts is not None and mask is None:
            # Unstacked per-column gather results, kept alongside the
            # stacked array: elementwise ops propagate them column-wise and
            # neighbor reductions consume them, so the canonical
            # ``neighbor_sum(remap * weights)`` pattern never materializes
            # the (n_src, ncols) stack (XLA DCEs the unused concatenate).
            # Cuts the stack write + read + strided reduce from the FVM
            # nabla hot path. Ephemeral hint — not part of the pytree.
            result._neighbor_parts = (conn.neighbor_dim, lazy_parts)
        return result

    def _reduce_index(self, dim: Dimension, index: int) -> "Field":
        axis = self.domain.index(dim)
        taken = self.ndarray.take(index, axis=axis)
        mask = self.mask.take(index, axis=axis) if self.mask is not None else None
        return Field(
            Domain(self.domain.ranges[:axis] + self.domain.ranges[axis + 1:]),
            taken,
            mask,
        )

    # -- restriction -------------------------------------------------------

    def __getitem__(self, item):
        """Absolute (domain-coordinate) indexing/restriction (reference
        NdArrayField.restrict :378 and absolute-indexing semantics of
        tests/next_tests/unit_tests/embedded_tests/test_nd_array_field.py
        :1055): entries are NamedRanges, ``(dim, (start, stop))`` pairs
        (restrict), or ``(dim, index)`` pairs (collapse the dimension).
        Collapsing every dimension returns the scalar value."""
        # Relative (positional) indexing: plain slices / ints / Ellipsis
        # map onto domain dims in order (reference
        # common.py:415 is_relative_index_sequence).
        def _is_rel(e):
            return (
                e is Ellipsis
                or isinstance(e, slice)
                or (isinstance(e, (int, np.integer)) and not isinstance(e, bool))
            )

        if not isinstance(item, NamedRange):
            if _is_rel(item) and not isinstance(item, tuple):
                return self._restrict_relative((item,))
            if isinstance(item, tuple) and item and all(_is_rel(e) for e in item):
                return self._restrict_relative(item)

        # NamedRange is a tuple, so disambiguate the single-entry forms:
        # a NamedRange itself, or a (Dimension, index-or-range) pair.
        if isinstance(item, NamedRange):
            item = (item,)
        elif (
            isinstance(item, tuple)
            and len(item) == 2
            and isinstance(item[0], Dimension)
        ):
            item = (item,)
        elif not isinstance(item, tuple):
            item = (item,)
        ranges = list(self.domain.ranges)
        slices = [slice(None)] * self.domain.ndim
        collapses: list[tuple[Dimension, int]] = []
        for entry in item:
            if isinstance(entry, NamedRange):
                pass
            elif (
                isinstance(entry, tuple)
                and len(entry) == 2
                and isinstance(entry[0], Dimension)
            ):
                dim, spec = entry
                if isinstance(spec, int) and not isinstance(spec, bool):
                    own = self.domain[dim].unit_range
                    if spec not in own:
                        raise IndexError(
                            f"index {spec} out of range {own} for {dim}"
                        )
                    collapses.append((dim, spec - own.start))
                    continue
                entry = NamedRange(dim, UnitRange.from_value(spec))
            else:
                raise TypeError(f"Invalid restriction: {entry!r}")
            axis = self.domain.index(entry.dim)
            own = self.domain.ranges[axis].unit_range
            if (
                entry.unit_range.start < own.start
                or entry.unit_range.stop > own.stop
            ):
                raise IndexError(
                    f"restriction {entry.unit_range} outside field range "
                    f"{own} for {entry.dim}"
                )
            rel = slice(
                entry.unit_range.start - own.start,
                entry.unit_range.stop - own.start,
            )
            slices[axis] = rel
            ranges[axis] = entry
        result = Field(
            Domain(tuple(ranges)),
            self.ndarray[tuple(slices)],
            self.mask[tuple(slices)] if self.mask is not None else None,
            base=(self, tuple(slices)) if not collapses else None,
        )
        for dim, rel_idx in collapses:
            result = result._reduce_index(dim, rel_idx)
        if collapses and result.domain.ndim == 0:
            return result.as_scalar()
        return result

    # -- arithmetic --------------------------------------------------------

    def _binary(self, other, op) -> "Field":
        xp = _xp(self.ndarray)

        if isinstance(other, Field):
            dims = _promote_dims(self.dims, other.dims)
            dom, a = self._aligned(dims, other)
            _, b = other._aligned(dims, self)
            result = op(a, b)
            mask = _combine_masks(xp, self, other, dims)
            out = Field(dom, result, mask)
            if mask is None:
                _propagate_parts(out, self, a, other, b, dims, dom, op)
            return out
        result = op(self.ndarray, other)
        out = Field(self.domain, result, self.mask)
        parts = getattr(self, "_neighbor_parts", None)
        if parts is not None and self.mask is None:
            out._neighbor_parts = (parts[0], tuple(op(p, other) for p in parts[1]))
        return out

    def _rbinary(self, other, op) -> "Field":
        result = op(other, self.ndarray)
        out = Field(self.domain, result, self.mask)
        parts = getattr(self, "_neighbor_parts", None)
        if parts is not None and self.mask is None:
            out._neighbor_parts = (parts[0], tuple(op(other, p) for p in parts[1]))
        return out

    def _aligned(self, dims: tuple[Dimension, ...], other: "Field"):
        """Slice to the intersected domain over ``dims`` and broadcast-insert
        missing axes; returns (target domain, array)."""
        target_ranges = []
        for d in dims:
            if d in self.domain and d in other.domain:
                r = self.domain[d].unit_range.intersection(other.domain[d].unit_range)
            elif d in self.domain:
                r = self.domain[d].unit_range
            else:
                r = other.domain[d].unit_range
            target_ranges.append(NamedRange(d, r))
        dom = Domain(tuple(target_ranges))

        arr = self.ndarray
        # Slice own dims to target ranges (in own axis order); axes with
        # unbounded ranges are broadcast placeholders (size 1) — no slicing.
        slices = []
        for nr in self.domain.ranges:
            t = dom[nr.dim].unit_range
            own = nr.unit_range
            if not own.is_finite:
                slices.append(slice(None))
            else:
                slices.append(slice(t.start - own.start, t.stop - own.start))
        arr = arr[tuple(slices)]
        # Transpose own dims into target order and insert missing axes.
        own_dims = [d for d in dims if d in self.domain]
        perm = [self.domain.index(d) for d in own_dims]
        if perm != sorted(perm):
            arr = arr.transpose(perm)
        xp = _xp(arr)

        shape = []
        expand = []
        for i, d in enumerate(dims):
            size = (
                len(dom[d].unit_range) if dom[d].unit_range.is_finite else 1
            )
            if d not in self.domain:
                expand.append(i)
            shape.append(size)
        for i in expand:
            arr = xp.expand_dims(arr, i)
        arr = xp.broadcast_to(arr, tuple(shape))
        return dom, arr

    def __add__(self, o):
        return self._binary(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._rbinary(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._binary(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._rbinary(o, lambda a, b: a / b)

    def __pow__(self, o):
        return self._binary(o, lambda a, b: a**b)

    def __rpow__(self, o):
        return self._rbinary(o, lambda a, b: a**b)

    def __mod__(self, o):
        return self._binary(o, lambda a, b: a % b)

    def __rmod__(self, o):
        return self._rbinary(o, lambda a, b: a % b)

    def __floordiv__(self, o):
        return self._binary(o, lambda a, b: a // b)

    def __rfloordiv__(self, o):
        return self._rbinary(o, lambda a, b: a // b)

    def __neg__(self):
        return Field(self.domain, -self.ndarray, self.mask)

    def __pos__(self):
        return self

    def __abs__(self):
        return Field(self.domain, _xp(self.ndarray).abs(self.ndarray), self.mask)

    def __invert__(self):
        return Field(self.domain, _xp(self.ndarray).logical_not(self.ndarray), self.mask)

    def __and__(self, o):
        return self._binary(o, _xp(self.ndarray).logical_and)

    def __or__(self, o):
        return self._binary(o, _xp(self.ndarray).logical_or)

    def __xor__(self, o):
        return self._binary(o, _xp(self.ndarray).logical_xor)

    def __eq__(self, o):  # type: ignore[override]
        return self._binary(o, lambda a, b: a == b)

    def __ne__(self, o):  # type: ignore[override]
        return self._binary(o, lambda a, b: a != b)

    def __lt__(self, o):
        return self._binary(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._binary(o, lambda a, b: a <= b)

    def __gt__(self, o):
        return self._binary(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._binary(o, lambda a, b: a >= b)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        # NumPy/JAX semantics: without this, Python's chained comparison
        # `a < b < c` silently evaluates as just `b < c` (the intermediate
        # Field is truthy by default) — a wrong-RESULTS trap, not an error.
        raise TypeError(
            "The truth value of a Field is ambiguous. For element-wise "
            "conjunction write (a < b) & (b < c); for branching use where()."
        )

    def __repr__(self) -> str:
        return f"Field({self.domain}, dtype={self.dtype})"


def _combine_masks(xp, a: Field, b, dims):
    if a.mask is None and (not isinstance(b, Field) or b.mask is None):
        return None
    parts = []
    for f in (a, b):
        if isinstance(f, Field) and f.mask is not None:
            mf = Field(f.domain, f.mask)
            _, arr = mf._aligned(dims, b if f is a else a)
            parts.append(arr)
    out = parts[0]
    for p in parts[1:]:
        out = xp.logical_and(out, p)
    return out


# -- pytree registration (jit over field-operator calls) ----------------------


def _field_flatten(f: Field):
    if f.mask is None:
        return (f.ndarray,), (f.domain, False)
    return (f.ndarray, f.mask), (f.domain, True)


def _field_unflatten(aux, children):
    domain, has_mask = aux
    f = object.__new__(Field)
    f.domain = domain
    f.ndarray = children[0]
    f.mask = children[1] if has_mask else None
    return f


def _register_pytree():
    import jax.tree_util as jtu

    jtu.register_pytree_node(Field, _field_flatten, _field_unflatten)


_register_pytree()
