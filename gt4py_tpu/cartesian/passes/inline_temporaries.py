"""Temporary inlining (recompute-for-fusion).

Counterpart of the reference's ``OnTheFlyMerging`` OIR pass
(/root/reference/src/gt4py/cartesian/gtc/passes/oir_optimizations/
horizontal_execution_merging.py:135): a temporary that is written once per
program point by an unmasked parallel assignment can be *recomputed* at its
read sites — substituting the defining expression shifted by the read offset
— instead of being materialized. On the XLA path statements then collapse
into single fused kernels (no device-memory round-trips for temporaries;
XLA CSEs the overlapping shifted reads).

Safety rules (same-section scope):
- only defs from unmasked, region-free, data-index-free assignments whose
  RHS uses constant offsets,
- a def dies when any field it reads (or the temp itself) is rewritten,
- substitution only within the section the def was made in,
- expression-size cap to bound recompute blow-up,
- assigns whose temp has no remaining reads anywhere are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from gt4py_tpu import eve
from gt4py_tpu.cartesian import gtir

# Max FieldAccess nodes in a fully inlined statement expression.
_SIZE_CAP = 256

# Max recompute volume per def: (forward reads served by the def) x
# (FieldAccess count of the defining expression). Multi-use temporaries
# with non-trivial defs (e.g. hdiff's laplacian, read at 4 shifted points:
# 4 reads x 5 accesses = 20 > cap) stay materialized; hdiff's res/flx/fly
# (2 reads x <=6 accesses) inline.
_EXPANSION_CAP = 12


def _shift_expr(expr: gtir.Expr, off: tuple[int, int, int]) -> gtir.Expr:
    """Clone with all field offsets shifted by ``off``."""
    if off == (0, 0, 0):
        return expr

    class Shifter(eve.NodeTranslator):
        def visit_FieldAccess(self, node: gtir.FieldAccess, **kwargs):
            return node.copy(
                offset=(
                    node.offset[0] + off[0],
                    node.offset[1] + off[1],
                    node.offset[2] + off[2],
                ),
                data_index=tuple(self.visit(i) for i in node.data_index),
            )

    return Shifter().visit(expr)


def _n_accesses(expr: gtir.Expr) -> int:
    return sum(1 for _ in eve.walk_type(expr, gtir.FieldAccess))


def _reads_of(expr: gtir.Expr) -> set[str]:
    return {a.name for a in eve.walk_type(expr, gtir.FieldAccess)}


def _inlinable_def(stmt: gtir.Assign) -> bool:
    if stmt.mask is not None or stmt.horizontal_masks or stmt.target.data_index:
        return False
    if stmt.target.offset[2] != 0 or stmt.target.koffset is not None:
        # A K-offset write is not a plain definition of the target.
        return False
    for a in eve.walk_type(stmt.value, gtir.FieldAccess):
        if a.koffset is not None or a.abs_k is not None or a.data_index:
            return False
    return True


class _Substituter(eve.NodeTranslator):
    def __init__(self, defs: dict[str, gtir.Expr]):
        self.defs = defs
        self.hit = False

    def visit_FieldAccess(self, node: gtir.FieldAccess, **kwargs):
        if node.name in self.defs and node.koffset is None and node.abs_k is None:
            self.hit = True
            return _shift_expr(self.defs[node.name], node.offset)
        return node


def inline_temporaries(
    stencil: gtir.Stencil, *, expansion_cap: Optional[int] = None
) -> gtir.Stencil:
    """Return a new stencil with inlinable temporaries substituted and dead
    temporary assignments removed.

    ``expansion_cap`` bounds recompute per def: forward reads x defining
    expression's access count. Single-forward-read defs always inline (no
    recompute is introduced)."""
    if expansion_cap is None:
        expansion_cap = _EXPANSION_CAP
    temps = {t.name for t in stencil.temporaries}

    new_loops: list[gtir.VerticalLoop] = []
    for vloop in stencil.vertical_loops:
        new_sections = []
        for section in vloop.sections:
            defs: dict[str, gtir.Expr] = {}
            new_body: list[gtir.Stmt] = []
            parallel = vloop.loop_order == gtir.LoopOrder.PARALLEL
            from gt4py_tpu.cartesian.passes.extents import iter_writes

            def _forward_reads(idx: int, name: str, def_value: gtir.Expr) -> int:
                """Reads of ``name`` in later statements served by the def at
                ``idx`` (counting stops where the def dies)."""
                def_reads = _reads_of(def_value)
                count = 0
                for later in section.body[idx + 1 :]:
                    count += sum(
                        1 for a in _stmt_read_accesses(later) if a.name == name
                    )
                    written = {w.name for w in iter_writes(later)}
                    if name in written or (def_reads & written):
                        break
                return count

            for idx, stmt in enumerate(section.body):
                stmt = _substitute_stmt(stmt, defs)
                # Kill defs invalidated by this statement's writes (the
                # def's temp itself, or any field its expression reads).
                written = {w.name for w in iter_writes(stmt)}
                for name in list(defs):
                    if name in written or (_reads_of(defs[name]) & written):
                        del defs[name]
                # Record the (already-substituted) def after invalidation.
                if (
                    parallel
                    and isinstance(stmt, gtir.Assign)
                    and stmt.target.name in temps
                    and _inlinable_def(stmt)
                    and _n_accesses(stmt.value) <= _SIZE_CAP
                ):
                    n_fwd = _forward_reads(idx, stmt.target.name, stmt.value)
                    if n_fwd <= 1 or n_fwd * _n_accesses(stmt.value) <= expansion_cap:
                        defs[stmt.target.name] = stmt.value
                new_body.append(stmt)
            new_sections.append(
                gtir.VerticalSection(
                    interval=section.interval, body=new_body, loc=section.loc
                )
            )
        new_loops.append(
            gtir.VerticalLoop(
                loop_order=vloop.loop_order, sections=new_sections, loc=vloop.loc
            )
        )

    # Drop assigns to temporaries that are never read anymore.
    read_counts: dict[str, int] = {}
    for vloop in new_loops:
        for section in vloop.sections:
            for stmt in section.body:
                for name in _stmt_read_names(stmt):
                    read_counts[name] = read_counts.get(name, 0) + 1
    for vloop in new_loops:
        for section in vloop.sections:
            section.body = [
                s
                for s in section.body
                if not (
                    isinstance(s, gtir.Assign)
                    and s.target.name in temps
                    and read_counts.get(s.target.name, 0) == 0
                )
            ]

    live_temps = [
        t
        for t in stencil.temporaries
        if read_counts.get(t.name, 0) > 0
        or any(
            isinstance(s, gtir.Stmt) and _writes_name(s, t.name)
            for vl in new_loops
            for sec in vl.sections
            for s in sec.body
        )
    ]
    return gtir.Stencil(
        name=stencil.name,
        params=stencil.params,
        vertical_loops=new_loops,
        temporaries=live_temps,
        externals=stencil.externals,
        docstring=stencil.docstring,
        loc=stencil.loc,
    )


def _substitute_stmt(stmt: gtir.Stmt, defs: dict[str, gtir.Expr]) -> gtir.Stmt:
    if not defs:
        return stmt
    if isinstance(stmt, gtir.While):
        # A while ITERATES: a def is only valid inside if nothing the loop
        # writes invalidates it (neither the def'd temp itself nor any
        # field its expression reads) — otherwise the substitution would
        # freeze the iteration state at its pre-loop value.
        from gt4py_tpu.cartesian.passes.extents import iter_writes

        body_writes = {w.name for w in iter_writes(stmt)}
        live = {
            k: v
            for k, v in defs.items()
            if k not in body_writes and not (_reads_of(v) & body_writes)
        }
        if not live:
            return stmt
        sub = _Substituter(live)
        new_cond = sub.visit(stmt.cond)
        new_mask = sub.visit(stmt.mask) if stmt.mask is not None else None
        new_body = [_substitute_stmt(s, live) for s in stmt.body]
        if not sub.hit and all(a is b for a, b in zip(new_body, stmt.body)):
            return stmt
        return stmt.copy(cond=new_cond, mask=new_mask, body=new_body)
    sub = _Substituter(defs)
    if isinstance(stmt, gtir.Assign):
        new_value = sub.visit(stmt.value)
        new_mask = sub.visit(stmt.mask) if stmt.mask is not None else None
        if not sub.hit:
            return stmt
        return stmt.copy(value=new_value, mask=new_mask)
    return stmt


def _stmt_read_accesses(stmt: gtir.Stmt) -> list[gtir.FieldAccess]:
    accs: list[gtir.FieldAccess] = []
    if isinstance(stmt, gtir.Assign):
        accs += list(eve.walk_type(stmt.value, gtir.FieldAccess))
        if stmt.mask is not None:
            accs += list(eve.walk_type(stmt.mask, gtir.FieldAccess))
        for i in stmt.target.data_index:
            accs += list(eve.walk_type(i, gtir.FieldAccess))
    elif isinstance(stmt, gtir.While):
        accs += list(eve.walk_type(stmt.cond, gtir.FieldAccess))
        if stmt.mask is not None:
            accs += list(eve.walk_type(stmt.mask, gtir.FieldAccess))
        for s in stmt.body:
            accs += _stmt_read_accesses(s)
    return accs


def _stmt_read_names(stmt: gtir.Stmt) -> set[str]:
    names: set[str] = set()
    if isinstance(stmt, gtir.Assign):
        names |= _reads_of(stmt.value)
        if stmt.mask is not None:
            names |= _reads_of(stmt.mask)
        for i in stmt.target.data_index:
            names |= _reads_of(i)
    elif isinstance(stmt, gtir.While):
        names |= _reads_of(stmt.cond)
        if stmt.mask is not None:
            names |= _reads_of(stmt.mask)
        for s in stmt.body:
            names |= _stmt_read_names(s)
    return names


def _writes_name(stmt: gtir.Stmt, name: str) -> bool:
    from gt4py_tpu.cartesian.passes.extents import iter_writes

    return any(w.name == name for w in iter_writes(stmt))
