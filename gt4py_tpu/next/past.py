"""PAST — program AST: the IR stage for ``@program`` definitions.

Role of the reference's ``gt4py.next.ffront`` PAST layer
(/root/reference/src/gt4py/next/ffront/func_to_past.py,
program_ast.py, past_passes/ + past_to_itir.py): the decorated program is
lowered to a statement IR over the shared FOAST expression nodes
(:mod:`gt4py_tpu.next.foast`), transformation/validation passes run on it,
and the result compiles back to the executable form.

Passes:
- **program type checking** (reference past_passes/type_deduction.py +
  ProgramLowering checks): every top-level operator call is resolved and
  its arguments / ``out=`` field are checked against the callee's deduced
  signature using the program's parameter annotations — errors surface at
  DECORATION time as structured DSL errors, before anything executes.
- constant folding (shared with FOAST) on domain and scalar expressions.
- dead temporary elimination: assignments to names never consumed by a
  later statement are dropped (operator calls are effectful and always
  kept).

Difference by design: the reference lowers PAST to ITIR program closures
compiled per-backend; here the executable target is Python that traces
into XLA — the whole-program ``jax.jit`` in ``Program.__call__`` is the
ProgramLowering analog (one XLA dispatch per program call), and PAST
passes shape the function that jit traces. Out-of-subset programs fall
back to the raw definition with the reason recorded
(``prog.past_fallback_reason``); ``GT4PY_FOAST_STRICT=1`` raises instead.
"""

from __future__ import annotations

import dataclasses
import ast
import os
from typing import Any, Callable, Optional

from gt4py_tpu.eve import Node, datamodel
from gt4py_tpu.next import foast
from gt4py_tpu.next.foast import (
    Assign,
    Call,
    Expr,
    FoastUnsupported,
    IfStmt,
    Literal,
    Name,
    Stmt,
    TupleExpr,
    _emit,
    _emit_stmt,
    _function_from_source,
    _closure_map,
)

__all__ = [
    "ProgramDefinition",
    "CallStmt",
    "func_to_past",
    "codegen",
    "compile_to_python",
    "exec_program",
    "static_scalar_params",
    "past_source",
]


@datamodel
class CallStmt(Stmt):
    """A top-level operator call statement — the program's unit of work
    (reference past.Program body: list of ffront Call closures). The
    ``out=`` keyword is required by the program lints; ``domain=`` and
    ``offset_provider=`` ride in ``call.kwargs``."""

    call: Call


@datamodel
class ProgramDefinition(Node):
    name: str
    params: list  # positional parameter names, in order
    body: list  # list[Stmt]
    kwonly_params: list = foast.field(default_factory=list)


# --- lowering -------------------------------------------------------------------


class _ProgramLowerer(foast._Lowerer):
    """FOAST lowerer extended with the program-only statement form:
    a bare expression statement that is an operator call."""

    def lower_expr(self, node: ast.expr) -> Expr:
        # Dict literals are program-only syntax: ``domain={I: (0, n)}``
        # (reference past.py domain arguments). Field-operator bodies
        # keep rejecting them in the base lowerer.
        if isinstance(node, ast.Dict):
            if any(k is None for k in node.keys):
                raise foast._unsupported(node, "**-unpacking in a dict")
            return foast.DictExpr(
                keys=[self.lower_expr(k) for k in node.keys],
                values=[self.lower_expr(v) for v in node.values],
            )
        return super().lower_expr(node)

    def lower_stmt(self, node: ast.stmt) -> Optional[Stmt]:
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            return CallStmt(call=self.lower_expr(node.value))
        if isinstance(node, ast.Return):
            # validate_definition(kind="program") already rejects value
            # returns; a bare return simply ends the body.
            if node.value is None:
                return None
            raise foast._unsupported(node, "programs do not return values")
        return super().lower_stmt(node)


def func_to_past(definition: Callable) -> ProgramDefinition:
    """Lower a program definition to PAST (reference func_to_past.py)."""
    from gt4py_tpu.next.frontend_validation import _definition_source

    parsed = _definition_source(definition)
    if parsed is None:
        raise FoastUnsupported("source unavailable (interactive definition)")
    fdef = parsed[0]
    if not isinstance(fdef, ast.FunctionDef):
        raise FoastUnsupported("definition is not a plain function")
    a = fdef.args
    if a.vararg or a.kwarg:
        raise FoastUnsupported("*args/**kwargs parameters")
    lowerer = _ProgramLowerer()
    return ProgramDefinition(
        name=fdef.name,
        params=[p.arg for p in (*a.posonlyargs, *a.args)],
        body=lowerer.lower_body(fdef.body),
        kwonly_params=[p.arg for p in a.kwonlyargs],
    )


def static_scalar_params(ir: ProgramDefinition) -> frozenset:
    """Program parameters whose VALUES shape the compiled program: names
    reachable from any ``domain=`` call argument or scalar ``if``
    condition, directly or through intermediate assignments.

    Under the whole-program jit these must be concrete Python values —
    domain bounds are XLA shapes and ``if`` picks the traced branch — so
    ``Program.__call__`` bakes them into the executable's cache key
    instead of tracing them. This is the reference's static-argument
    descriptor role (reference otf/arguments.py:40-116 ``StaticArg`` /
    ``FieldDomainDescriptor``) realized on ``jax.jit``'s terms.
    """
    from gt4py_tpu.eve.trees import walk_type

    wanted: set = set()
    assigns: list = []  # (target names, names read by the value)

    def collect(body: list) -> None:
        for s in body:
            if isinstance(s, CallStmt):
                dom = s.call.kwargs.get("domain")
                if dom is not None:
                    wanted.update(n.id for n in walk_type(dom, Name))
            elif isinstance(s, IfStmt):
                wanted.update(n.id for n in walk_type(s.cond, Name))
                collect(s.body)
                collect(s.orelse)
            elif isinstance(s, Assign):
                tnames = {t.id for t in walk_type(s.targets, Name)}
                vnames = {n.id for n in walk_type(s.value, Name)}
                assigns.append((tnames, vnames))

    collect(ir.body)
    # Fixpoint: a temporary feeding a domain makes its own inputs static.
    changed = True
    while changed:
        changed = False
        for tnames, vnames in assigns:
            if tnames & wanted and not vnames <= wanted:
                wanted |= vnames
                changed = True
    return frozenset(wanted & {*ir.params, *ir.kwonly_params})


# --- codegen --------------------------------------------------------------------


def _emit_past_stmt(s: Stmt, lines: list, indent: int) -> None:
    pad = "    " * indent
    if isinstance(s, CallStmt):
        lines.append(f"{pad}{_emit(s.call)}")
    elif isinstance(s, IfStmt):
        lines.append(f"{pad}if {_emit(s.cond)}:")
        if s.body:
            for b in s.body:
                _emit_past_stmt(b, lines, indent + 1)
        else:
            lines.append(f"{pad}    pass")
        if s.orelse:
            lines.append(f"{pad}else:")
            for b in s.orelse:
                _emit_past_stmt(b, lines, indent + 1)
    else:
        _emit_stmt(s, lines, indent)


def codegen(ir: ProgramDefinition) -> str:
    """PAST -> Python source (executable AND pretty form)."""
    sig = list(ir.params)
    if ir.kwonly_params:
        sig += ["*", *ir.kwonly_params]
    lines = [f"def {ir.name}({', '.join(sig)}):"]
    if not ir.body:
        lines.append("    pass")
    for s in ir.body:
        _emit_past_stmt(s, lines, 1)
    return "\n".join(lines) + "\n"


# --- program type checking (past_passes/type_deduction analog) -------------------


def check_program_types(
    ir: ProgramDefinition, definition: Callable
) -> None:
    """Statically check every top-level operator call against the callee's
    deduced signature, using the program's parameter annotations
    (reference past_passes/type_deduction.py + the out-field checks in
    past_to_itir.ProgramLowering). No-ops per call when the callee has no
    type info or an argument's type is unknowable."""
    import inspect

    import numpy as np

    from gt4py_tpu.next import type_system as ts
    from gt4py_tpu.next import errors
    from gt4py_tpu.next import type_deduction as td

    globalns = getattr(definition, "__globals__", {}) or {}
    closure = _closure_map(definition)

    try:
        sig = inspect.signature(definition)
    except (TypeError, ValueError):
        return
    env: dict[str, Any] = {}
    for pname, p in sig.parameters.items():
        spec = ts.from_annotation(p.annotation, globalns)
        env[pname] = spec if spec is not None else td.UNKNOWN

    def spec_of(e: Expr) -> Any:
        if isinstance(e, Name):
            if e.id in env:
                return env[e.id]
            value = closure.get(e.id, globalns.get(e.id))
            if value is None:
                return td.UNKNOWN
            spec = td._classify_value(value)
            return spec
        if isinstance(e, Literal):
            if isinstance(e.value, bool):
                return td._WeakScalar("bool")
            if isinstance(e.value, int):
                return td._WeakScalar("int")
            if isinstance(e.value, float):
                return td._WeakScalar("float")
            return td.UNKNOWN
        if isinstance(e, TupleExpr):
            elts = [spec_of(x) for x in e.elts]
            if any(s is td.UNKNOWN for s in elts):
                return td.UNKNOWN
            return ts.TupleType(tuple(elts))
        return td.UNKNOWN

    def check_out(declared: Any, got: Any, opname: str) -> Optional[str]:
        if declared is None or declared is td.UNKNOWN or got is td.UNKNOWN:
            return None
        if isinstance(declared, ts.TupleType):
            if not isinstance(got, ts.TupleType) or len(got.types) != len(
                declared.types
            ):
                return (
                    f"out= of {opname}() must be a {len(declared.types)}-tuple "
                    f"matching the return type {declared}"
                )
            for i, (d, g) in enumerate(zip(declared.types, got.types)):
                msg = check_out(d, g, opname)
                if msg is not None:
                    return msg
            return None
        if isinstance(declared, ts.FieldType):
            if not isinstance(got, ts.FieldType):
                return f"out= of {opname}() must be a Field (returns {declared})"
            extra = [d for d in got.dims if d not in declared.dims]
            if extra:
                return (
                    f"out= of {opname}() has dimension(s) "
                    f"{', '.join(d.value for d in extra)} not produced by the "
                    f"operator (returns {declared})"
                )
            if np.dtype(got.dtype) != np.dtype(declared.dtype):
                return (
                    f"out= of {opname}() has dtype {np.dtype(got.dtype)} but "
                    f"the operator returns {np.dtype(declared.dtype)}"
                )
        return None

    def check_call(stmt: CallStmt) -> None:
        call = stmt.call
        ref = spec_of(call.func)
        if not isinstance(ref, td._OperatorRef):
            return
        info = ref.info
        names = list(info.params)
        opname = ref.name
        if len(call.args) > len(names):
            raise errors.DSLTypeError(
                None,
                f"{opname}() takes {len(names)} arguments but "
                f"{len(call.args)} were given (program '{ir.name}').",
            )
        bound = dict(zip(names, call.args))
        for k, v in call.kwargs.items():
            if k in ("out", "domain", "offset_provider"):
                continue
            if k not in names:
                raise errors.DSLTypeError(
                    None,
                    f"{opname}() has no parameter '{k}' "
                    f"(program '{ir.name}').",
                )
            bound[k] = v
        for pname, declared in info.params.items():
            arg = bound.get(pname)
            if arg is None or declared is td.UNKNOWN:
                continue
            got = spec_of(arg)
            if got is td.UNKNOWN:
                continue
            ok = (
                td._scan_arg_compatible(declared, got)
                if ref.is_scan
                else td._compatible(declared, got)
            )
            if not ok:
                raise errors.DSLTypeError(
                    None,
                    f"Argument '{pname}' of {opname}(): expected {declared}, "
                    f"got {td._fmt(got)} (program '{ir.name}').",
                )
        out_expr = call.kwargs.get("out")
        if out_expr is not None:
            msg = check_out(info.returns, spec_of(out_expr), opname)
            if msg is not None:
                raise errors.DSLTypeError(None, f"{msg} (program '{ir.name}').")

    def walk(body: list) -> None:
        for stmt in body:
            if isinstance(stmt, CallStmt):
                check_call(stmt)
            elif isinstance(stmt, IfStmt):
                walk(stmt.body)
                walk(stmt.orelse)

    walk(ir.body)


# --- dead temporary elimination ---------------------------------------------------


def eliminate_dead_temporaries(ir: ProgramDefinition) -> ProgramDefinition:
    """Drop assignments whose targets no later statement reads. Operator
    call statements are effectful (they write ``out=`` fields) and are
    always kept, and every name they mention counts as read."""
    from gt4py_tpu.next.foast_passes import _reads, _target_names

    def dce(body: list, live: set) -> list:
        out: list = []
        for stmt in reversed(body):
            if isinstance(stmt, CallStmt):
                live |= _reads(stmt.call)
                out.append(stmt)
            elif isinstance(stmt, Assign):
                names = [n for t in stmt.targets for n in _target_names(t)]
                if not any(n in live for n in names):
                    continue
                for n in names:
                    live.discard(n)
                live |= _reads(stmt.value)
                out.append(stmt)
            elif isinstance(stmt, IfStmt):
                live_t, live_f = set(live), set(live)
                body_t = dce(stmt.body, live_t)
                body_f = dce(stmt.orelse, live_f)
                live.clear()
                live |= live_t | live_f | _reads(stmt.cond)
                out.append(IfStmt(cond=stmt.cond, body=body_t, orelse=body_f))
            else:
                out.append(stmt)
        out.reverse()
        return out

    return ProgramDefinition(
        name=ir.name, params=ir.params, body=dce(ir.body, set()),
        kwonly_params=ir.kwonly_params,
    )


# --- compile + integration ---------------------------------------------------------


@dataclasses.dataclass
class CompiledPast:
    fn: Optional[Callable]
    ir: Optional[ProgramDefinition]
    reason: Optional[str]


def compile_to_python(definition: Callable) -> CompiledPast:
    """definition -> PAST -> passes -> Python function; fallback (with
    reason) on out-of-subset constructs, strict-raise under
    GT4PY_FOAST_STRICT=1 for pipeline bugs."""
    from gt4py_tpu.next.foast_passes import fold_constants

    try:
        ir = func_to_past(definition)
        check_program_types(ir, definition)  # decoration-time type errors
        ir = fold_constants(ir)
        ir = eliminate_dead_temporaries(ir)
        src = codegen(ir)
        fn = _function_from_source(src, ir.name, definition, None)
        return CompiledPast(fn=fn, ir=ir, reason=None)
    except FoastUnsupported as exc:
        return CompiledPast(fn=None, ir=None, reason=str(exc))


def exec_program(prog: Any) -> Callable:
    """The callable a Program should EXECUTE: the PAST-compiled function
    when lowering succeeds, else the raw definition. Cached on the
    program object. Type errors raised by the checking pass propagate
    (they are user errors, not pipeline fallbacks)."""
    cache = prog.__dict__.get("_past_cache")
    if cache is None:
        cache = compile_to_python(prog.definition)
        prog.__dict__["_past_cache"] = cache
        if cache.reason is not None:
            prog.__dict__["past_fallback_reason"] = cache.reason
    return cache.fn if cache.fn is not None else prog.definition


def past_source(prog: Any) -> str:
    """The post-pass generated source (``prog.inspect(stage="past")``)."""
    fn = exec_program(prog)
    src = getattr(fn, "__gt_foast_source__", None)
    if src is None:
        reason = prog.__dict__.get("past_fallback_reason", "unknown")
        raise ValueError(
            f"program is outside the PAST subset (runs the raw "
            f"definition): {reason}"
        )
    return src
