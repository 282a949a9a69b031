"""Fuse parallel temporary definitions into consuming sequential loops.

Counterpart of the reference's vertical-loop merging / on-the-fly merging
roles (/root/reference/src/gt4py/cartesian/gtc/passes/oir_optimizations/
vertical_loop_merging.py:1, horizontal_execution_merging.py:135) for the
PARALLEL→FORWARD/BACKWARD boundary: a temporary written by a PARALLEL
loop and read only inside ONE sequential loop at zero offset is computed
per level inside that loop instead — the kernel then streams the inputs
once and keeps the coefficient values in registers, instead of
materializing full-size temporaries between grid sweeps (each extra sweep
costs a full device-memory round trip).

This is the pass that makes a field-view vadv written with
``concat_where`` boundary sections compile into the SAME 3-section
sequential stencil a GTScript author writes by hand: the concat_where
temporaries (multi-section PARALLEL loops) split the consumer's sections
at their piece boundaries and their defining assignments are prepended
per section.

Safety rules:
- the temporary is written only in one PARALLEL loop, by plain
  assignments (no mask, no region, no variable-K/absolute-K/data-index
  target),
- every read sits in ONE later sequential loop at offset (0, 0, 0),
- defining expressions may read inputs at any offset, but other MOVED
  temporaries only at zero offset (a K-offset read of a value that is now
  computed level-by-level would see unmaterialized data — such
  dependencies keep the referenced temporary materialized instead),
- the defining loop's sections must cover every (refined) section of the
  consumer.

Interval bounds are compared symbolically: START-relative bounds order by
offset, END-relative likewise, and every START bound precedes every END
bound — the same well-formedness assumption GTIR section ordering already
makes (enforced at call time via ``min_sequential_axis_size``).
"""

from __future__ import annotations

from typing import Iterator, Optional

from gt4py_tpu import eve
from gt4py_tpu.cartesian import gtir


def _key(b: gtir.AxisBound) -> tuple[int, int]:
    return (0 if b.level == gtir.LevelMarker.START else 1, b.offset)


def _bound(key: tuple[int, int]) -> gtir.AxisBound:
    marker, off = key
    return (
        gtir.AxisBound.start(off) if marker == 0 else gtir.AxisBound.end(off)
    )


def _iter_stmts(body) -> Iterator[gtir.Stmt]:
    for st in body:
        yield st
        if isinstance(st, (gtir.While, gtir.HorizontalRestriction)):
            yield from _iter_stmts(st.body)
        elif isinstance(st, gtir.If):  # pragma: no cover — lowered away
            yield from _iter_stmts(st.body)
            yield from _iter_stmts(st.orelse)


def _stmt_reads(st: gtir.Stmt) -> Iterator[gtir.FieldAccess]:
    if isinstance(st, gtir.Assign):
        yield from eve.walk_type(st.value, gtir.FieldAccess)
        if st.mask is not None:
            yield from eve.walk_type(st.mask, gtir.FieldAccess)
        for idx in st.target.data_index:
            yield from eve.walk_type(idx, gtir.FieldAccess)
        if st.target.koffset is not None:
            yield from eve.walk_type(st.target.koffset, gtir.FieldAccess)
        if st.target.abs_k is not None:
            yield from eve.walk_type(st.target.abs_k, gtir.FieldAccess)
    elif isinstance(st, (gtir.While,)):
        yield from eve.walk_type(st.cond, gtir.FieldAccess)
        if st.mask is not None:
            yield from eve.walk_type(st.mask, gtir.FieldAccess)


def _plain_assign(st: gtir.Stmt) -> bool:
    return (
        isinstance(st, gtir.Assign)
        and st.mask is None
        and not st.horizontal_masks
        and st.target.offset == (0, 0, 0)
        and st.target.koffset is None
        and st.target.abs_k is None
        and not st.target.data_index
    )


def fuse_parallel_temporaries(
    stencil: gtir.Stencil, _exclude: frozenset = frozenset()
) -> gtir.Stencil:
    loops = stencil.vertical_loops
    if len(loops) < 2 or not stencil.temporaries:
        return stencil
    temp_names = {t.name for t in stencil.temporaries}

    # site maps ---------------------------------------------------------
    # writes: name -> list[(loop_idx, section_idx, stmt, is_plain_toplevel)]
    writes: dict[str, list] = {}
    reads: dict[str, list] = {}  # name -> list[(loop_idx, top_stmt, access)]
    order: dict[int, int] = {}  # id(stmt) -> global program order
    def_owner: dict[int, str] = {}  # id(top stmt) -> temp it (plainly) defines
    write_loops: dict[str, set] = {}  # any written name -> loop indices
    n = 0
    for li, vl in enumerate(loops):
        for si, sec in enumerate(vl.sections):
            for st in sec.body:
                order[id(st)] = n
                n += 1
                toplevel_plain = _plain_assign(st)
                if toplevel_plain and st.target.name in temp_names:
                    def_owner[id(st)] = st.target.name
                for sub in _iter_stmts([st]):
                    if isinstance(sub, gtir.Assign):
                        tname = sub.target.name
                        write_loops.setdefault(tname, set()).add((li, order[id(st)]))
                        if tname in temp_names:
                            writes.setdefault(tname, []).append(
                                (li, si, st, toplevel_plain and sub is st)
                            )
                    for r in _stmt_reads(sub):
                        if r.name in temp_names:
                            reads.setdefault(r.name, []).append((li, st, r))

    # write-side candidates ----------------------------------------------
    base: dict[str, tuple] = {}  # temp -> (wli, pieces)
    for t in temp_names:
        ws = writes.get(t, [])
        if not ws or not reads.get(t):
            continue
        wlis = {w[0] for w in ws}
        if len(wlis) != 1:
            continue
        wli = wlis.pop()
        if loops[wli].loop_order != gtir.LoopOrder.PARALLEL:
            continue
        if not all(plain for _, _, _, plain in ws):
            continue
        secs = [si for _, si, _, _ in ws]
        if len(secs) != len(set(secs)):  # one def per section
            continue
        pieces = []
        for _, si, st, _ in ws:
            sec = loops[wli].sections[si]
            pieces.append((_key(sec.interval.start), _key(sec.interval.end), st))
        pieces.sort(key=lambda p: p[0])
        if t not in _exclude:
            base[t] = (wli, pieces)

    # read-side closure: a temp moves when every read is at zero offset
    # and sits either directly in ONE sequential loop, or inside the
    # (already moved) definition of another temp headed to that same loop
    # -- so whole coefficient chains (ksections pieces feeding composite
    # rhs temps feeding a scan) migrate together.
    # Coverage failures remove the temp from `base` and restart the whole
    # closure: dependents that moved only because of it must be recomputed
    # (a dangling ingredient moved past its unmoved reader would be read
    # before it is written).
    moved: dict[str, dict] = {}
    changed = True
    while changed:
        changed = False
        for t, (wli, pieces) in base.items():
            if t in moved:
                continue
            eff: set[int] = set()
            ok = True
            for li, st, r in reads[t]:
                if (
                    r.offset != (0, 0, 0)
                    or r.koffset is not None
                    or r.abs_k is not None
                ):
                    ok = False
                    break
                owner = def_owner.get(id(st))
                if owner is not None and owner != t and owner in moved:
                    eff.add(moved[owner]["rli"])
                else:
                    eff.add(li)
            if not ok or len(eff) != 1:
                continue
            rli = eff.pop()
            if rli <= wli or loops[rli].loop_order == gtir.LoopOrder.PARALLEL:
                continue
            # A moved definition must not read anything written AFTER it
            # (later loop, or same loop at a later statement) — evaluating
            # the definition later (inside the consumer) would observe the
            # updated value. Earlier writers are fine whether or not they
            # co-move: global statement order is preserved per section.
            for _, _, dstmt in pieces:
                dorder = order[id(dstmt)]
                for f in _stmt_reads(dstmt):
                    if any(
                        wl > wli or (wl == wli and worder > dorder)
                        for wl, worder in write_loops.get(f.name, ())
                    ):
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                continue
            moved[t] = {"wli": wli, "rli": rli, "pieces": pieces}
            changed = True
    if not moved:
        return stencil

    # group by consumer loop; verify coverage, refine sections -----------
    new_loops: list[Optional[gtir.VerticalLoop]] = list(loops)
    removed_stmts: set[int] = set()
    failed_any = None
    by_consumer: dict[int, list[str]] = {}
    for t, info in moved.items():
        by_consumer.setdefault(info["rli"], []).append(t)

    for rli, tnames in by_consumer.items():
        cuts = set()
        for t in tnames:
            for ps, pe, _ in moved[t]["pieces"]:
                cuts.add(ps)
                cuts.add(pe)
        consumer = loops[rli]
        new_sections: list[gtir.VerticalSection] = []
        for sec in consumer.sections:
            a, b = _key(sec.interval.start), _key(sec.interval.end)
            inner = sorted(c for c in cuts if a < c < b)
            bounds = [a, *inner, b]
            for lo, hi in zip(bounds, bounds[1:]):
                defs: list[gtir.Stmt] = []
                for t in tnames:
                    cover = next(
                        (
                            st
                            for ps, pe, st in moved[t]["pieces"]
                            if ps <= lo and hi <= pe
                        ),
                        None,
                    )
                    if cover is None:
                        failed_any = t
                        break
                    defs.append(cover)
                if failed_any:
                    break
                defs.sort(key=lambda st: order[id(st)])
                new_sections.append(
                    gtir.VerticalSection(
                        interval=gtir.Interval(
                            start=_bound(lo), end=_bound(hi)
                        ),
                        body=defs + list(sec.body),
                    )
                )
            if failed_any:
                break
        if failed_any:
            break
        new_loops[rli] = gtir.VerticalLoop(
            loop_order=consumer.loop_order, sections=new_sections
        )
        for t in tnames:
            for _, _, st in moved[t]["pieces"]:
                removed_stmts.add(id(st))

    if failed_any is not None:
        # Drop the uncoverable temp and redo the whole analysis: temps
        # that moved only because this one moved must be recomputed.
        return fuse_parallel_temporaries(stencil, _exclude | {failed_any})

    if not removed_stmts:
        return stencil

    # strip moved defs from their parallel loops --------------------------
    result_loops: list[gtir.VerticalLoop] = []
    for li, vl in enumerate(loops):
        if new_loops[li] is not vl:
            result_loops.append(new_loops[li])
            continue
        sections = []
        for sec in vl.sections:
            body = [st for st in sec.body if id(st) not in removed_stmts]
            if body:
                sections.append(
                    gtir.VerticalSection(interval=sec.interval, body=body)
                )
        if sections:
            result_loops.append(
                gtir.VerticalLoop(loop_order=vl.loop_order, sections=sections)
            )

    return gtir.Stencil(
        name=stencil.name,
        params=stencil.params,
        vertical_loops=result_loops,
        temporaries=stencil.temporaries,
        externals=stencil.externals,
        docstring=stencil.docstring,
        loc=stencil.loc,
    )
