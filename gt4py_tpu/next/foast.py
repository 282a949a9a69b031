"""FOAST — typed field-operator AST: the IR stage between the Python
definition and execution.

Role of the reference's ``gt4py.next.ffront`` FOAST layer
(/root/reference/src/gt4py/next/ffront/func_to_foast.py,
field_operator_ast.py): the decorated definition is lowered to a small
expression IR, transformation passes run on it
(:mod:`gt4py_tpu.next.foast_passes` — constant folding, dead-code
elimination, common-subexpression elimination, reduction unrolling,
temporary extraction), and the result is compiled back to an executable.

Difference by design: the reference lowers FOAST onward to ITIR and
C++/DaCe codegen; here the executable target is *Python that traces into
XLA* — :func:`codegen` emits a function semantically equivalent to the
original definition (same global namespace, same builtins), so everything
downstream (jit, sharding, the cartesian bridge) is unchanged.
The passes are therefore real program transformations observable in the
emitted source (``op.inspect(stage="foast")``) and in the jaxpr/HLO.

Lowering is *total or absent*: any construct outside the DSL subset makes
:func:`compile_to_python` return a fallback (reason recorded on the
operator as ``foast_fallback_reason``) and the raw definition runs
instead — never a partially-transformed hybrid. The NumPy oracle path
always runs the raw definition, so every oracle test doubles as a
FOAST-equivalence check.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import types
from typing import Any, Callable, Optional

import numpy as np

from gt4py_tpu.eve import Node, datamodel, field


__all__ = [
    "TransformOptions",
    "FoastUnsupported",
    "func_to_foast",
    "codegen",
    "compile_to_python",
    "exec_definition",
    "foast_source",
]


# --- IR nodes -----------------------------------------------------------------


class Expr(Node):
    __slots__ = ()


class Stmt(Node):
    __slots__ = ()


@datamodel
class Name(Expr):
    id: str


@datamodel
class Literal(Expr):
    value: Any  # python scalar: bool | int | float | complex | str | None


@datamodel
class TupleExpr(Expr):
    elts: list


@datamodel
class Starred(Expr):
    """``*name`` inside a tuple assignment target (reference func_to_foast
    star-unpacking support, tests .../test_tuples.py star-multi cases)."""

    value: Expr  # always a Name


@datamodel
class ListExpr(Expr):
    elts: list


@datamodel
class DictExpr(Expr):
    """``{k: v, ...}`` literal. Program subset only (``domain=`` call
    arguments, reference past.py program domains); field-operator bodies
    keep rejecting dicts — they have no elementwise meaning."""

    keys: list
    values: list


@datamodel
class UnaryOp(Expr):
    op: str  # '+' | '-' | 'not' | '~'
    operand: Expr


@datamodel
class BinOp(Expr):
    op: str  # '+','-','*','/','//','%','**','@','&','|','^','<<','>>'
    left: Expr
    right: Expr


@datamodel
class BoolOp(Expr):
    op: str  # 'and' | 'or'
    values: list


@datamodel
class Compare(Expr):
    """Single comparison (chained comparisons are rejected at lowering —
    on fields they have no elementwise meaning, matching the cartesian
    frontend's rule)."""

    op: str  # '==','!=','<','<=','>','>='
    left: Expr
    right: Expr


@datamodel
class IfExpr(Expr):
    cond: Expr
    true_expr: Expr
    false_expr: Expr


@datamodel
class Call(Expr):
    """Any call: builtins (``neighbor_sum``), nested operators, and field
    shifts ``f(V2E)`` / ``f(Ioff[1])`` (shifting IS ``Field.__call__``)."""

    func: Expr
    args: list
    kwargs: dict  # name -> Expr


@datamodel
class Subscript(Expr):
    value: Expr
    index: Expr  # Expr | SliceExpr | TupleExpr of those


@datamodel
class SliceExpr(Expr):
    lower: Optional[Expr] = None
    upper: Optional[Expr] = None
    step: Optional[Expr] = None


@datamodel
class Attribute(Expr):
    value: Expr
    attr: str


@datamodel
class Assign(Stmt):
    """``a = expr`` / ``a = b = expr`` / ``a, b = expr``. Targets are
    Name or TupleExpr-of-Name nodes."""

    targets: list
    value: Expr


@datamodel
class Return(Stmt):
    value: Expr


@datamodel
class IfStmt(Stmt):
    """Scalar (python-value) conditional — fields in conditions trace-fail
    exactly as in the raw definition; this stays a *statement* so both
    behaviors match."""

    cond: Expr
    body: list
    orelse: list


@datamodel
class FieldOperatorDefinition(Node):
    name: str
    params: list  # positional parameter names, in signature order
    body: list  # list[Stmt]
    kwonly_params: list = field(default_factory=list)  # names after ``*``

    @property
    def all_params(self) -> list:
        return [*self.params, *self.kwonly_params]


# --- lowering: Python AST -> FOAST ---------------------------------------------


class FoastUnsupported(Exception):
    """A construct outside the FOAST subset; the operator falls back to
    the raw definition (recorded, never silent)."""


_BINOPS = {
    ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
    ast.FloorDiv: "//", ast.Mod: "%", ast.Pow: "**", ast.MatMult: "@",
    ast.BitAnd: "&", ast.BitOr: "|", ast.BitXor: "^",
    ast.LShift: "<<", ast.RShift: ">>",
}
_UNOPS = {ast.UAdd: "+", ast.USub: "-", ast.Not: "not", ast.Invert: "~"}
_CMPOPS = {
    ast.Eq: "==", ast.NotEq: "!=", ast.Lt: "<", ast.LtE: "<=",
    ast.Gt: ">", ast.GtE: ">=",
}


def _unsupported(node: ast.AST, why: str) -> FoastUnsupported:
    line = getattr(node, "lineno", "?")
    return FoastUnsupported(f"line {line}: {why}")


class _Lowerer:
    def lower_function(self, fdef: ast.FunctionDef) -> FieldOperatorDefinition:
        a = fdef.args
        if a.vararg or a.kwarg:
            raise _unsupported(fdef, "*args/**kwargs parameters")
        params = [p.arg for p in (*a.posonlyargs, *a.args)]
        kwonly = [p.arg for p in a.kwonlyargs]
        body = self.lower_body(fdef.body)
        return FieldOperatorDefinition(
            name=fdef.name, params=params, body=body, kwonly_params=kwonly
        )

    def lower_body(self, stmts: list) -> list:
        out: list = []
        for s in stmts:
            lowered = self.lower_stmt(s)
            if lowered is not None:
                out.append(lowered)
        return out

    def lower_stmt(self, node: ast.stmt) -> Optional[Stmt]:
        if isinstance(node, ast.Expr):
            if isinstance(node.value, ast.Constant) and isinstance(
                node.value.value, str
            ):
                return None  # docstring
            raise _unsupported(node, "expression statement with no effect")
        if isinstance(node, ast.Assign):
            return Assign(
                targets=[self._lower_target(t) for t in node.targets],
                value=self.lower_expr(node.value),
            )
        if isinstance(node, ast.AnnAssign):
            if node.value is None:
                raise _unsupported(node, "annotation without a value")
            return Assign(
                targets=[self._lower_target(node.target)],
                value=self.lower_expr(node.value),
            )
        if isinstance(node, ast.AugAssign):
            if not isinstance(node.target, ast.Name):
                raise _unsupported(node, "augmented assignment to a non-name")
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise _unsupported(node, f"operator {type(node.op).__name__}")
            return Assign(
                targets=[Name(id=node.target.id)],
                value=BinOp(
                    op=op, left=Name(id=node.target.id),
                    right=self.lower_expr(node.value),
                ),
            )
        if isinstance(node, ast.Return):
            if node.value is None:
                raise _unsupported(node, "bare return")
            return Return(value=self.lower_expr(node.value))
        if isinstance(node, ast.If):
            return IfStmt(
                cond=self.lower_expr(node.test),
                body=self.lower_body(node.body),
                orelse=self.lower_body(node.orelse),
            )
        if isinstance(node, ast.Pass):
            return None
        raise _unsupported(node, f"statement {type(node).__name__}")

    def _lower_target(self, node: ast.expr) -> Expr:
        if isinstance(node, ast.Name):
            return Name(id=node.id)
        if isinstance(node, ast.Tuple):
            elts = []
            n_star = 0
            for e in node.elts:
                if isinstance(e, ast.Name):
                    elts.append(Name(id=e.id))
                elif isinstance(e, ast.Starred) and isinstance(e.value, ast.Name):
                    n_star += 1
                    elts.append(Starred(value=Name(id=e.value.id)))
                else:
                    raise _unsupported(
                        node, "assignment target must be a name or name-tuple"
                    )
            if n_star > 1:
                raise _unsupported(node, "multiple starred assignment targets")
            return TupleExpr(elts=elts)
        raise _unsupported(node, "assignment target must be a name or name-tuple")

    def lower_expr(self, node: ast.expr) -> Expr:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (bool, int, float, complex, str, type(None))):
                return Literal(value=node.value)
            raise _unsupported(node, f"constant {type(node.value).__name__}")
        if isinstance(node, ast.Name):
            return Name(id=node.id)
        if isinstance(node, ast.Tuple):
            return TupleExpr(elts=[self.lower_expr(e) for e in node.elts])
        if isinstance(node, ast.List):
            return ListExpr(elts=[self.lower_expr(e) for e in node.elts])
        if isinstance(node, ast.BinOp):
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise _unsupported(node, f"operator {type(node.op).__name__}")
            return BinOp(
                op=op, left=self.lower_expr(node.left),
                right=self.lower_expr(node.right),
            )
        if isinstance(node, ast.UnaryOp):
            op = _UNOPS.get(type(node.op))
            if op is None:
                raise _unsupported(node, f"operator {type(node.op).__name__}")
            return UnaryOp(op=op, operand=self.lower_expr(node.operand))
        if isinstance(node, ast.BoolOp):
            op = "and" if isinstance(node.op, ast.And) else "or"
            return BoolOp(op=op, values=[self.lower_expr(v) for v in node.values])
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise _unsupported(
                    node, "chained comparison (no elementwise meaning on fields)"
                )
            op = _CMPOPS.get(type(node.ops[0]))
            if op is None:
                raise _unsupported(
                    node, f"comparison {type(node.ops[0]).__name__}"
                )
            return Compare(
                op=op, left=self.lower_expr(node.left),
                right=self.lower_expr(node.comparators[0]),
            )
        if isinstance(node, ast.IfExp):
            return IfExpr(
                cond=self.lower_expr(node.test),
                true_expr=self.lower_expr(node.body),
                false_expr=self.lower_expr(node.orelse),
            )
        if isinstance(node, ast.Call):
            if any(isinstance(a, ast.Starred) for a in node.args):
                raise _unsupported(node, "*-unpacking in a call")
            kwargs: dict = {}
            for kw in node.keywords:
                if kw.arg is None:
                    raise _unsupported(node, "**-unpacking in a call")
                kwargs[kw.arg] = self.lower_expr(kw.value)
            return Call(
                func=self.lower_expr(node.func),
                args=[self.lower_expr(a) for a in node.args],
                kwargs=kwargs,
            )
        if isinstance(node, ast.Subscript):
            return Subscript(
                value=self.lower_expr(node.value),
                index=self._lower_index(node.slice),
            )
        if isinstance(node, ast.Attribute):
            return Attribute(value=self.lower_expr(node.value), attr=node.attr)
        raise _unsupported(node, f"expression {type(node).__name__}")

    def _lower_index(self, node: ast.expr) -> Expr:
        if isinstance(node, ast.Slice):
            return SliceExpr(
                lower=self.lower_expr(node.lower) if node.lower else None,
                upper=self.lower_expr(node.upper) if node.upper else None,
                step=self.lower_expr(node.step) if node.step else None,
            )
        if isinstance(node, ast.Tuple):
            return TupleExpr(elts=[self._lower_index(e) for e in node.elts])
        return self.lower_expr(node)


def func_to_foast(definition: Callable) -> FieldOperatorDefinition:
    """Lower a decorated definition to FOAST (reference func_to_foast.py).
    Raises :class:`FoastUnsupported` on out-of-subset constructs."""
    from gt4py_tpu.next.frontend_validation import _definition_source

    parsed = _definition_source(definition)
    if parsed is None:
        raise FoastUnsupported("source unavailable (interactive definition)")
    fdef = parsed[0]
    if not isinstance(fdef, ast.FunctionDef):
        raise FoastUnsupported("definition is not a plain function")
    return _Lowerer().lower_function(fdef)


# --- codegen: FOAST -> Python source -------------------------------------------

# Every composite expression is parenthesized, so operator precedence never
# has to be reproduced; the emitted source is the canonical pretty form.


def _emit(e: Expr) -> str:
    if isinstance(e, Name):
        return e.id
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, TupleExpr):
        inner = ", ".join(_emit(x) for x in e.elts)
        return f"({inner},)" if len(e.elts) == 1 else f"({inner})"
    if isinstance(e, Starred):
        return f"*{_emit(e.value)}"
    if isinstance(e, ListExpr):
        return "[" + ", ".join(_emit(x) for x in e.elts) + "]"
    if isinstance(e, DictExpr):
        items = ", ".join(
            f"{_emit(k)}: {_emit(v)}" for k, v in zip(e.keys, e.values)
        )
        return "{" + items + "}"
    if isinstance(e, UnaryOp):
        if e.op == "not":
            # runtime dispatch: plain bools keep Python `not`, traced
            # scalar bools use logical_not (Python `not` raises on
            # tracers), Fields are rejected (use ~ / where)
            return f"__gtx_not__({_emit(e.operand)})"
        return f"({e.op}{_emit(e.operand)})"
    if isinstance(e, BinOp):
        return f"({_emit(e.left)} {e.op} {_emit(e.right)})"
    if isinstance(e, BoolOp):
        return "(" + f" {e.op} ".join(_emit(v) for v in e.values) + ")"
    if isinstance(e, Compare):
        return f"({_emit(e.left)} {e.op} {_emit(e.right)})"
    if isinstance(e, IfExpr):
        # Runtime-dispatched ternary: plain-bool conditions keep Python
        # short-circuit semantics; Field / traced-array conditions lower
        # to where() with both branches evaluated (reference
        # foast_to_gtir ternary lowering). The thunks keep the untaken
        # branch unevaluated for compile-time conditions.
        return (
            f"__gtx_ternary__({_emit(e.cond)}, "
            f"lambda: {_emit(e.true_expr)}, lambda: {_emit(e.false_expr)})"
        )
    if isinstance(e, Call):
        parts = [_emit(a) for a in e.args]
        parts += [f"{k}={_emit(v)}" for k, v in e.kwargs.items()]
        return f"{_emit(e.func)}({', '.join(parts)})"
    if isinstance(e, Subscript):
        return f"{_emit(e.value)}[{_emit_index(e.index)}]"
    if isinstance(e, Attribute):
        return f"{_emit(e.value)}.{e.attr}"
    if isinstance(e, SliceExpr):
        return _emit_index(e)
    raise TypeError(f"cannot emit {type(e).__name__}")


def _emit_index(e: Expr) -> str:
    if isinstance(e, SliceExpr):
        lo = _emit(e.lower) if e.lower is not None else ""
        hi = _emit(e.upper) if e.upper is not None else ""
        s = f"{lo}:{hi}"
        if e.step is not None:
            s += f":{_emit(e.step)}"
        return s
    if isinstance(e, TupleExpr):
        return ", ".join(_emit_index(x) for x in e.elts)
    return _emit(e)


def _emit_stmt(s: Stmt, lines: list, indent: int) -> None:
    pad = "    " * indent
    if isinstance(s, Assign):
        tgt = " = ".join(_emit(t) for t in s.targets)
        lines.append(f"{pad}{tgt} = {_emit(s.value)}")
    elif isinstance(s, Return):
        lines.append(f"{pad}return {_emit(s.value)}")
    elif isinstance(s, IfStmt):
        lines.append(f"{pad}if {_emit(s.cond)}:")
        if s.body:
            for b in s.body:
                _emit_stmt(b, lines, indent + 1)
        else:
            lines.append(f"{pad}    pass")
        if s.orelse:
            lines.append(f"{pad}else:")
            for b in s.orelse:
                _emit_stmt(b, lines, indent + 1)
    else:
        raise TypeError(f"cannot emit {type(s).__name__}")


def codegen(ir: FieldOperatorDefinition) -> str:
    """FOAST -> Python source (the executable form AND the pretty form)."""
    sig = list(ir.params)
    if ir.kwonly_params:
        sig += ["*", *ir.kwonly_params]
    lines = [f"def {ir.name}({', '.join(sig)}):"]
    if not ir.body:
        lines.append("    pass")
    for s in ir.body:
        _emit_stmt(s, lines, 1)
    return "\n".join(lines) + "\n"


# --- compile: FOAST source -> function object ----------------------------------


@dataclasses.dataclass(frozen=True)
class TransformOptions:
    """User-facing transform knobs for the field-view pipeline — the
    analog of the reference pass-manager options
    (/root/reference/src/gt4py/next/iterator/transforms/pass_manager.py:135-144:
    ``common_subexpression_elimination``, ``extract_temporaries``,
    ``unroll_reduce``). ``extract_temporaries`` materializes each
    assignment through ``lax.optimization_barrier`` — the XLA-native way
    to force a fusion boundary (the effect of the reference's
    global_tmps pass). ``unroll_reduce`` expands neighbor reductions
    into per-neighbor partial shifts (halved gather volume per column;
    connectivities with skip values stay on the masked-remap path)."""

    enabled: bool = True
    constant_folding: bool = True
    dead_code_elimination: bool = True
    common_subexpression_elimination: bool = True
    unroll_reduce: bool = False
    extract_temporaries: bool = False
    #: x ** <small int literal> -> square-and-multiply (reference
    #: power_unrolling pass); multiplications instead of transcendental pow.
    unroll_powers: bool = True
    #: (a, b)[0] -> a (reference collapse_tuple role)
    collapse_tuple: bool = True
    #: scalar if-statements dispatch at runtime: plain bools keep Python
    #: short-circuit, traced scalars lower to per-name selects (reference
    #: uses_if_stmts semantics)
    lower_ifs: bool = True

    def replace(self, **kw: Any) -> "TransformOptions":
        return dataclasses.replace(self, **kw)

    def key(self) -> tuple:
        return dataclasses.astuple(self)


def default_options() -> TransformOptions:
    if os.environ.get("GT4PY_NEXT_TRANSFORMS", "1") in ("0", "false", "off"):
        return TransformOptions(enabled=False)
    return TransformOptions()


def _gtx_is_plain_bool(x: Any) -> bool:
    """Runtime dispatch predicate for lowered if-statements."""
    return isinstance(x, (bool, np.bool_))


def _gtx_ternary(cond: Any, true_thunk: Callable, false_thunk: Callable) -> Any:
    """Runtime form of ``a if cond else b`` in a field operator.

    Python-bool conditions (compile-time flags, folded scalar chains)
    branch natively. Everything else — Fields, traced arrays, per-level
    scan values, bridge SymNodes — evaluates both branches and selects
    with ``where`` (the reference lowers FOAST ternaries the same way,
    ffront/foast_to_gtir.py ``visit_IfExp``). Tuple branches (e.g. a
    NamedTuple scan carry, test_icon_like_scan.py:49) select leaf-wise,
    preserving the carry structure."""
    if isinstance(cond, (bool, np.bool_)):
        return true_thunk() if cond else false_thunk()
    from gt4py_tpu.next.fbuiltins import where

    a = true_thunk()
    b = false_thunk()
    if isinstance(a, tuple) or isinstance(b, tuple):
        import jax.tree_util as jtu

        if jtu.tree_structure(a) != jtu.tree_structure(b):
            raise TypeError(
                "ternary branches must have the same (tuple) structure, got "
                f"{type(a).__name__} vs {type(b).__name__}"
            )
        return jtu.tree_map(lambda x, y: where(cond, x, y), a, b)
    return where(cond, a, b)


def _gtx_not(x: Any) -> Any:
    """Runtime form of ``not x``: plain bools keep Python semantics,
    traced scalar bools go through logical_not (Python ``not`` raises
    TracerBoolConversionError), Fields are rejected (the reference
    wants ``~``/``where`` for elementwise negation)."""
    if isinstance(x, (bool, np.bool_)):
        return not x
    from gt4py_tpu.next.embedded import Field

    if isinstance(x, Field):
        raise TypeError(
            "'not' is not defined on Fields — use '~field' or 'where'"
        )
    import jax.numpy as jnp

    return jnp.logical_not(x)


def _gtx_scalar_cond(cond: Any) -> Any:
    """Validate an if-statement condition: must be scalar and boolean
    (reference type_deduction: "Condition for 'if' must be scalar" /
    "must be of boolean type"; elementwise selection is spelled
    ``where``). Returns the condition unchanged when valid."""
    from gt4py_tpu.next.embedded import Field

    if isinstance(cond, Field):
        raise TypeError(
            "Condition for 'if' must be scalar, got a Field — use "
            "'where(cond, a, b)' for elementwise selection"
        )
    if getattr(cond, "ndim", 0) > 0:
        raise TypeError(
            "Condition for 'if' must be scalar, got an array of rank "
            f"{cond.ndim} — use 'where' for elementwise selection"
        )
    dt = getattr(cond, "dtype", None)
    if dt is not None and np.dtype(dt) != np.dtype(bool):
        raise TypeError(
            f"Condition for 'if' must be of boolean type, got {dt}"
        )
    if isinstance(cond, (int, float)) and not isinstance(cond, bool):
        raise TypeError(
            f"Condition for 'if' must be of boolean type, got "
            f"{type(cond).__name__}"
        )
    return cond


def _function_from_source(
    src: str, name: str, definition: Callable, inject: Optional[dict]
) -> Callable:
    """Build a function object from generated source sharing the
    definition's *live* globals (no namespace pollution: the code object
    is extracted from the compiled module and wrapped directly)."""
    if "__gtx_ternary__(" in src:
        inject = {**(inject or {}), "__gtx_ternary__": _gtx_ternary}
    if "__gtx_is_plain_bool__(" in src:
        inject = {
            **(inject or {}),
            "__gtx_is_plain_bool__": _gtx_is_plain_bool,
        }
    if "__gtx_scalar_cond__(" in src:
        inject = {
            **(inject or {}),
            "__gtx_scalar_cond__": _gtx_scalar_cond,
        }
    if "__gtx_not__(" in src:
        inject = {**(inject or {}), "__gtx_not__": _gtx_not}
    module = compile(src, f"<foast:{name}>", "exec")
    code = next(
        c
        for c in module.co_consts
        if isinstance(c, types.CodeType) and c.co_name == name
    )
    gns = definition.__globals__
    freevars = definition.__code__.co_freevars
    if freevars or inject:
        # Closure cells / injected helpers can't ride the live module
        # globals: snapshot (cells are resolved at first-call time, after
        # decoration, so forward references inside the cell are filled).
        gns = dict(gns)
        if freevars:
            for fname, cell in zip(freevars, definition.__closure__ or ()):
                try:
                    gns[fname] = cell.cell_contents
                except ValueError:
                    raise FoastUnsupported(
                        f"closure cell '{fname}' not yet filled"
                    ) from None
        if inject:
            gns.update(inject)
    fn = types.FunctionType(
        code, gns, name, definition.__defaults__, None
    )
    if definition.__kwdefaults__:
        fn.__kwdefaults__ = dict(definition.__kwdefaults__)
    fn.__gt_foast__ = True
    fn.__gt_foast_source__ = src
    return fn


@dataclasses.dataclass
class CompiledFoast:
    fn: Optional[Callable]  # None on fallback
    ir: Optional[FieldOperatorDefinition]
    reason: Optional[str]  # fallback reason, None on success


def compile_to_python(
    definition: Callable,
    options: TransformOptions,
    *,
    offset_provider: Optional[dict] = None,
    type_info: Any = None,
) -> CompiledFoast:
    """definition -> FOAST -> passes -> Python function.

    ``offset_provider`` is only consulted by provider-dependent passes
    (``unroll_reduce``); the provider-independent pipeline compiles once
    per operator. Failures anywhere fall back to the raw definition with
    the reason recorded — set ``GT4PY_FOAST_STRICT=1`` to raise instead
    (the test suite runs strict, so silent-fallback regressions fail)."""
    from gt4py_tpu.next import foast_passes

    try:
        ir = func_to_foast(definition)
        ir, inject = foast_passes.apply_common_transforms(
            ir,
            options,
            globals_ns=definition.__globals__,
            closure=_closure_map(definition),
            offset_provider=offset_provider,
            type_info=type_info,
        )
        src = codegen(ir)
        fn = _function_from_source(src, ir.name, definition, inject)
        return CompiledFoast(fn=fn, ir=ir, reason=None)
    except FoastUnsupported as exc:
        return CompiledFoast(fn=None, ir=None, reason=str(exc))
    except Exception as exc:  # pipeline bug: fall back, never break user code
        if os.environ.get("GT4PY_FOAST_STRICT") == "1":
            raise
        return CompiledFoast(
            fn=None, ir=None, reason=f"internal ({type(exc).__name__}: {exc})"
        )


def _closure_map(definition: Callable) -> dict:
    freevars = definition.__code__.co_freevars
    if not freevars:
        return {}
    out = {}
    for fname, cell in zip(freevars, definition.__closure__ or ()):
        try:
            out[fname] = cell.cell_contents
        except ValueError:
            pass
    return out


# --- operator integration -------------------------------------------------------


def exec_definition(op: Any, *, offset_provider: Optional[dict] = None) -> Callable:
    """The callable a FieldOperator should EXECUTE: the FOAST-compiled
    function when lowering succeeds, else the raw definition. Cached per
    (options, provider-fingerprint-when-unrolling) on the operator."""
    options = getattr(op, "transform_options", None) or default_options()
    if not options.enabled:
        return op.definition
    key: tuple = options.key()
    if options.unroll_reduce:
        if offset_provider is None:
            from gt4py_tpu.next.embedded import _OFFSET_PROVIDER

            offset_provider = _OFFSET_PROVIDER.get()
        from gt4py_tpu.next.otf import _provider_fingerprint

        key = key + (
            tuple(
                sorted(
                    (k, _provider_fingerprint(v))
                    for k, v in (offset_provider or {}).items()
                )
            ),
        )
    cache = op.__dict__.setdefault("_foast_cache", {})
    hit = cache.get(key)
    if hit is None:
        hit = compile_to_python(
            op.definition,
            options,
            offset_provider=offset_provider,
            type_info=getattr(op, "type_info", None),
        )
        cache[key] = hit
        if hit.reason is not None:
            op.__dict__["foast_fallback_reason"] = hit.reason
    return hit.fn if hit.fn is not None else op.definition


def foast_source(op: Any, *, offset_provider: Optional[dict] = None) -> str:
    """The post-pass generated source (``op.inspect(stage="foast")``);
    raises with the recorded reason when the operator is out of subset."""
    fn = exec_definition(op, offset_provider=offset_provider)
    src = getattr(fn, "__gt_foast_source__", None)
    if src is None:
        reason = op.__dict__.get("foast_fallback_reason", "unknown")
        raise ValueError(
            f"operator is outside the FOAST subset (runs the raw "
            f"definition): {reason}"
        )
    return src
