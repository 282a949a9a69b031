"""Field-operator -> cartesian-kernel bridge.

SURVEY §7 step 8: the field-view layer reuses the achieved cartesian
kernel substrate. A field operator whose offsets are all CARTESIAN (the
structured I/J/K subset) is symbolically traced into cartesian GTIR — the
definition runs once on :class:`SymNode` placeholders that record the
expression DAG; shifted composite subexpressions become GTIR temporaries
(exactly hdiff's ``lap``) — and then executes through the registered
cartesian backends (``gpu``: XLA plus the K-sweep kernel for scans;
``jax``: the fused XLA evaluator).

Reference correspondence: this plays the role of
foast_to_gtir lowering (/root/reference/src/gt4py/next/ffront/
foast_to_gtir.py:70) for the cartesian subset, with tracing instead of an
AST pipeline. Unstructured offsets (connectivity tables), neighbor
reductions, scans and tuple returns stay on the embedded JAX path.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Optional

import numpy as np

from gt4py_tpu.cartesian import gtir
from gt4py_tpu.next.common import Dimension, DimensionKind


class BridgeUnsupported(Exception):
    pass


_BINOPS = {
    "add": gtir.ArithmeticOperator.ADD,
    "sub": gtir.ArithmeticOperator.SUB,
    "mul": gtir.ArithmeticOperator.MUL,
    "div": gtir.ArithmeticOperator.DIV,
    "mod": gtir.ArithmeticOperator.MOD,
    "pow": gtir.ArithmeticOperator.POW,
    "gt": gtir.ComparisonOperator.GT,
    "ge": gtir.ComparisonOperator.GE,
    "lt": gtir.ComparisonOperator.LT,
    "le": gtir.ComparisonOperator.LE,
    "eq": gtir.ComparisonOperator.EQ,
    "ne": gtir.ComparisonOperator.NE,
    "and": gtir.LogicalOperator.AND,
    "or": gtir.LogicalOperator.OR,
}

_NATIVE = {
    "abs": gtir.NativeFunction.ABS,
    "minimum": gtir.NativeFunction.MIN,
    "maximum": gtir.NativeFunction.MAX,
    "mod": gtir.NativeFunction.MOD,
    "sin": gtir.NativeFunction.SIN,
    "cos": gtir.NativeFunction.COS,
    "tan": gtir.NativeFunction.TAN,
    "arcsin": gtir.NativeFunction.ASIN,
    "arccos": gtir.NativeFunction.ACOS,
    "arctan": gtir.NativeFunction.ATAN,
    "sinh": gtir.NativeFunction.SINH,
    "cosh": gtir.NativeFunction.COSH,
    "tanh": gtir.NativeFunction.TANH,
    "arcsinh": gtir.NativeFunction.ASINH,
    "arccosh": gtir.NativeFunction.ACOSH,
    "arctanh": gtir.NativeFunction.ATANH,
    "sqrt": gtir.NativeFunction.SQRT,
    "cbrt": gtir.NativeFunction.CBRT,
    "exp": gtir.NativeFunction.EXP,
    "log": gtir.NativeFunction.LOG,
    "floor": gtir.NativeFunction.FLOOR,
    "ceil": gtir.NativeFunction.CEIL,
    "trunc": gtir.NativeFunction.TRUNC,
    "isfinite": gtir.NativeFunction.ISFINITE,
    "isinf": gtir.NativeFunction.ISINF,
    "isnan": gtir.NativeFunction.ISNAN,
}


class _Tracer:
    def __init__(self, dim_axis: dict, providers: dict, float_dtype: np.dtype):
        self.dim_axis = dim_axis  # Dimension -> 0|1|2
        self.providers = providers or {}
        self.float_dtype = np.dtype(float_dtype)
        self.temps: list[SymNode] = []
        self._n = 0
        # Multi-loop tracing (scan compositions): vertical loops flushed in
        # program order; scan outputs become stencil temporaries whose
        # defining statements live inside their sequential loop.
        self.loops: list[Any] = []
        self._flushed = 0  # index into temps of the first unflushed temp
        self.scan_out_names: list[str] = []
        self._scan_n = 0
        # Vertical range of the out domain (start, stop) — set by the
        # variant builders; concat_where boundary coordinates resolve
        # against it (the variant key pins this range, signature_key).
        self.k_range: Optional[tuple[int, int]] = None

    def lift(self, value: Any) -> "SymNode":
        if isinstance(value, SymNode):
            return value
        if isinstance(value, (bool, np.bool_)):
            return SymNode(self, "literal", (bool(value), np.dtype(bool)), ())
        if isinstance(value, (int, np.integer)):
            return SymNode(self, "literal", (int(value), np.dtype(np.int32)), ())
        if isinstance(value, (float, np.floating)):
            return SymNode(self, "literal", (float(value), self.float_dtype), ())
        raise BridgeUnsupported(f"cannot lift {type(value).__name__} into GTIR")

    def make_temp(self, node: "SymNode") -> str:
        if node.temp_name is None:
            node.temp_name = f"__bridge_tmp_{self._n}"
            self._n += 1
            self.temps.append(node)
        return node.temp_name

    def concat_k(self, cond: Any, a: Any, b: Any) -> "SymNode":
        """Lower ``concat_where(KDim <op> v, a, b)`` to K-interval
        sections (reference experimental concat_where,
        ffront/experimental.py:52, which gtfn compiles to per-interval
        stencil executions). The result is a temporary assigned ``a`` on
        the satisfying sub-interval(s) and ``b`` elsewhere — specialized
        straight-line sections instead of per-point masks, which is what
        lets vadv-style boundary coefficients ride the K-sweep kernel at
        cartesian parity."""
        axis = self.dim_axis.get(cond.dim)
        if axis != 2:
            raise BridgeUnsupported(
                "concat_where condition is not on the vertical dimension"
            )
        if self.k_range is None:
            raise BridgeUnsupported("concat_where without a vertical out domain")
        s0, s1 = self.k_range
        nk = s1 - s0

        def clamp(x: int) -> int:
            return max(0, min(nk, x))

        # Breakpoints from the condition's coordinate regions, relative to
        # the out K start; segments pick child 0 (true) or 1 (false) by
        # midpoint membership, then coalesce.
        points = {0, nk}
        for reg in cond.regions:
            points.add(clamp(reg.start - s0))
            points.add(clamp(reg.stop - s0))
        cuts = sorted(points)
        segs: list[tuple[int, int, int]] = []
        for lo, hi in zip(cuts, cuts[1:]):
            if lo >= hi:
                continue
            coord = s0 + lo
            which = 0 if any(coord in reg for reg in cond.regions) else 1
            if segs and segs[-1][2] == which:
                segs[-1] = (segs[-1][0], hi, which)
            else:
                segs.append((lo, hi, which))
        children = (self.lift(a), self.lift(b))
        if len(segs) == 1:
            return children[segs[0][2]]
        node = SymNode(self, "ksections", (tuple(segs), nk), children)
        self.make_temp(node)
        return node

    def flush_parallel(self, final_assign: Optional[tuple] = None) -> None:
        """Emit pending temp definitions as one PARALLEL vertical loop
        (called before a sequential scan loop so the scan's materialized
        arguments exist; also for the final out assignment). Statements are
        ordered by data dependency, not creation order — materializing a
        scan's composite arguments can register a consumer (``diag``)
        before one of its inputs (``upper``). concat_where temporaries
        (kind "ksections") emit as their own multi-section loops between
        the full-interval batches. ``final_assign=(name, node)`` appends
        ``name = node`` to the last batch (the variant's out write)."""
        pending = self.temps[self._flushed:]
        if not pending and final_assign is None:
            return

        def deps(node: "SymNode", root: "SymNode"):
            for child in node.children:
                if child.temp_name is not None and child is not root:
                    yield child
                else:
                    yield from deps(child, root)

        ordered: list[SymNode] = []
        seen: set[int] = set()
        pending_ids = {id(t) for t in pending}

        def visit(t: "SymNode") -> None:
            if id(t) in seen or id(t) not in pending_ids:
                return
            seen.add(id(t))
            for d in deps(t, t):
                visit(d)
            ordered.append(t)

        for t in pending:
            visit(t)

        memo: dict = {}
        body: list[gtir.Stmt] = []

        def emit_batch() -> None:
            if body:
                self.loops.append(
                    gtir.VerticalLoop(
                        loop_order=gtir.LoopOrder.PARALLEL,
                        sections=[
                            gtir.VerticalSection(
                                interval=gtir.Interval.full(), body=list(body)
                            )
                        ],
                    )
                )
                body.clear()

        def k_bound(pos: int, nk: int) -> gtir.AxisBound:
            return (
                gtir.AxisBound.end(0)
                if pos == nk
                else gtir.AxisBound.start(pos)
            )

        for tnode in ordered:
            if tnode.kind == "ksections":
                # concat_where temp: one loop, one section per K piece.
                emit_batch()
                segs, nk = tnode.data
                sections = []
                for lo, hi, which in segs:
                    sections.append(
                        gtir.VerticalSection(
                            interval=gtir.Interval(
                                start=k_bound(lo, nk), end=k_bound(hi, nk)
                            ),
                            body=[
                                gtir.Assign(
                                    target=gtir.FieldAccess(
                                        name=tnode.temp_name, offset=(0, 0, 0)
                                    ),
                                    value=_to_expr(tnode.children[which], {}),
                                )
                            ],
                        )
                    )
                self.loops.append(
                    gtir.VerticalLoop(
                        loop_order=gtir.LoopOrder.PARALLEL, sections=sections
                    )
                )
                continue
            body.append(
                gtir.Assign(
                    target=gtir.FieldAccess(name=tnode.temp_name, offset=(0, 0, 0)),
                    value=_to_expr(tnode, memo, defining=tnode),
                )
            )
        self._flushed = len(self.temps)
        if final_assign is not None:
            name, node = final_assign
            body.append(
                gtir.Assign(
                    target=gtir.FieldAccess(name=name, offset=(0, 0, 0)),
                    value=_to_expr(node, memo),
                )
            )
        emit_batch()

    def trace_scan(self, op: Any, args: tuple, kwargs: dict):
        """Inline a ScanOperator call made on symbolic values: append a
        two-section sequential vertical loop and return symbolic reads of
        its output temp field(s). This is the fusion point that lets scan
        compositions (tridiagonal solves, vadv) compile into ONE cartesian
        stencil whose cross-loop temporaries ride registers in the K-sweep
        kernel (reference analog: lift inlining into gtfn
        ScanExecution, codegens/gtfn/itir_to_gtfn_ir.py)."""
        import jax

        axis_slot = self.dim_axis.get(op.axis)
        if axis_slot != 2:
            raise BridgeUnsupported("scan axis is not the vertical (K) dimension")

        sig = inspect.signature(op.definition)
        names = list(sig.parameters)
        if kwargs:
            # Bind keyword arguments into the positional slots after carry.
            try:
                bound = sig.bind(None, *args, **kwargs)
                bound.apply_defaults()
            except TypeError as e:
                raise BridgeUnsupported(f"traced scan call signature: {e}")
            args = tuple(bound.arguments[n] for n in names[1:])
        if len(args) != len(names) - 1:
            raise BridgeUnsupported("traced scan call arity mismatch")

        # Materialize composite arguments as PARALLEL temporaries; field
        # and scalar nodes read directly.
        arg_nodes: list[SymNode] = []
        for a in args:
            node = self.lift(a)
            if node.kind in ("field", "scalar", "literal"):
                arg_nodes.append(node)
            else:
                name = self.make_temp(node)
                arg_nodes.append(SymNode(self, "field", (name, (0, 0, 0)), ()))
        self.flush_parallel()

        init_leaves = jax.tree_util.tree_leaves(op.init)
        for v in init_leaves:
            if not isinstance(
                v, (bool, int, float, np.integer, np.floating, np.bool_)
            ):
                raise BridgeUnsupported("non-scalar scan init")
        out_names = []
        for _ in init_leaves:
            out_names.append(f"__scan_out_{self._scan_n}")
            self._scan_n += 1
        self.scan_out_names.extend(out_names)
        forward = bool(op.forward)
        dk = -1 if forward else 1
        init_struct = jax.tree_util.tree_structure(op.init)

        def trace_section(carry_leaves) -> list[gtir.Stmt]:
            carry = jax.tree_util.tree_unflatten(init_struct, carry_leaves)
            n_before = len(self.temps)
            from gt4py_tpu.next.foast import exec_definition

            result = exec_definition(op)(carry, *arg_nodes)
            if len(self.temps) != n_before:
                raise BridgeUnsupported("shift of a composite inside a scan body")
            leaves = jax.tree_util.tree_leaves(
                result, is_leaf=lambda x: isinstance(x, SymNode)
            )
            if len(leaves) != len(out_names):
                raise BridgeUnsupported("scan result structure mismatch")
            memo: dict = {}
            return [
                gtir.Assign(
                    target=gtir.FieldAccess(name=oname, offset=(0, 0, 0)),
                    value=_to_expr(self.lift(node), memo),
                )
                for oname, node in zip(out_names, leaves)
            ]

        first_body = trace_section([self.lift(v) for v in init_leaves])

        # Constant-after-first carry specialization: a carry leaf whose
        # first-section value is a literal L, and whose rest-section value
        # re-traces to the SAME literal when the carry read is assumed to
        # be L, is constant at every level the rest section sees (proof by
        # induction over K). Feed the literal instead of a field read so
        # dependent selections fold (the icon-like `first_level: bool`
        # pattern, reference test_icon_like_scan.py:43-53, compiles to
        # straight-line sections with no bool stream or masks).
        lit_vals: dict[int, tuple] = {}
        for i, st in enumerate(first_body):
            if isinstance(st.value, gtir.Literal):
                lit_vals[i] = (st.value.value, st.value.dtype)
        const_idx = set(lit_vals)
        while True:
            carry_nodes = [
                SymNode(self, "literal", lit_vals[i], ())
                if i in const_idx
                else SymNode(self, "field", (o, (0, 0, dk)), ())
                for i, o in enumerate(out_names)
            ]
            rest_body = trace_section(carry_nodes)
            bad = {
                i
                for i in const_idx
                if not (
                    isinstance(rest_body[i].value, gtir.Literal)
                    and (rest_body[i].value.value, rest_body[i].value.dtype)
                    == lit_vals[i]
                )
            }
            if not bad:
                break
            const_idx -= bad
        sections = _scan_sections(forward, first_body, rest_body)
        self.loops.append(
            gtir.VerticalLoop(
                loop_order=(
                    gtir.LoopOrder.FORWARD if forward else gtir.LoopOrder.BACKWARD
                ),
                sections=sections,
            )
        )
        outs = tuple(
            SymNode(self, "field", (o, (0, 0, 0)), ()) for o in out_names
        )
        return jax.tree_util.tree_unflatten(init_struct, outs)

    def resolve_offset(self, offset: Any) -> tuple[int, int]:
        """-> (axis, delta) for cartesian offsets; raises otherwise."""
        from gt4py_tpu.next.common import (
            CartesianConnectivity,
            FieldOffset,
            OffsetIndex,
        )

        if isinstance(offset, OffsetIndex):
            fo = offset.offset
            mapped = self.providers.get(fo.value)
            if isinstance(mapped, Dimension):
                dim, delta = mapped, offset.index
            elif mapped is None and fo.target == (fo.source,):
                dim, delta = fo.source, offset.index
            else:
                raise BridgeUnsupported(f"offset '{fo.value}' is not cartesian")
        elif isinstance(offset, CartesianConnectivity):
            dim, delta = offset.dim, offset.offset
        else:
            raise BridgeUnsupported(f"offset {offset!r} is not cartesian")
        if dim not in self.dim_axis:
            raise BridgeUnsupported(f"dimension {dim} not in the operator's I/J/K map")
        return self.dim_axis[dim], int(delta)


class SymNode:
    """Symbolic value recorded while the definition executes."""

    _gt_symbolic_ = True
    __slots__ = ("tr", "kind", "data", "children", "temp_name")

    def __init__(self, tr: _Tracer, kind: str, data: Any, children: tuple):
        self.tr = tr
        self.kind = kind
        self.data = data
        self.children = children
        self.temp_name: Optional[str] = None

    # -- shifting ----------------------------------------------------------

    def __call__(self, offset: Any) -> "SymNode":
        axis, delta = self.tr.resolve_offset(offset)
        if self.kind == "field":
            name, off = self.data
            new = list(off)
            new[axis] += delta
            return SymNode(self.tr, "field", (name, tuple(new)), ())
        if self.kind == "scalar" or self.kind == "literal":
            return self
        # shifted composite: materialize as a GTIR temporary and read it at
        # the offset (this is exactly how hdiff's `lap` becomes a temp)
        name = self.tr.make_temp(self)
        off = [0, 0, 0]
        off[axis] = delta
        return SymNode(self.tr, "field", (name, tuple(off)), ())

    # -- operators -----------------------------------------------------------

    def _bin(self, op: str, other: Any, reverse: bool = False) -> "SymNode":
        o = self.tr.lift(other)
        left, right = (o, self) if reverse else (self, o)
        return SymNode(self.tr, "binop", op, (left, right))

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, True)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("div", o, True)

    def __mod__(self, o):
        return self._bin("mod", o)

    def __pow__(self, o):
        return self._bin("pow", o)

    def __gt__(self, o):
        return self._bin("gt", o)

    def __ge__(self, o):
        return self._bin("ge", o)

    def __lt__(self, o):
        return self._bin("lt", o)

    def __le__(self, o):
        return self._bin("le", o)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("eq", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin("ne", o)

    def __and__(self, o):
        return self._bin("and", o)

    def __or__(self, o):
        return self._bin("or", o)

    def __neg__(self):
        return SymNode(self.tr, "neg", None, (self,))

    def __invert__(self):
        return SymNode(self.tr, "not", None, (self,))

    def __abs__(self):
        return SymNode(self.tr, "call", gtir.NativeFunction.ABS, (self,))

    __hash__ = object.__hash__

    def __bool__(self):
        raise BridgeUnsupported(
            "data-dependent Python control flow inside a field operator"
        )

    # -- fbuiltins hook --------------------------------------------------------

    def _builtin(self, name: str, *args: Any) -> "SymNode":
        if name == "where":
            cond, a, b = (self.tr.lift(x) for x in args)
            # Fold literal selections: a literal condition picks its
            # branch (first-scan-level tracing feeds literal carries);
            # equal literal branches collapse (the icon-like
            # `first_level=False` in both ternary arms). This is what
            # lets constant-after-first carry leaves specialize out of
            # the sequential sections (trace_scan below).
            if cond.kind == "literal":
                return a if cond.data[0] else b
            if a.kind == "literal" and b.kind == "literal" and a.data == b.data:
                return a
            return SymNode(self.tr, "ternary", None, (cond, a, b))
        if name == "concat_where":
            cond, a, b = args
            return self.tr.concat_k(cond, a, b)
        if name == "astype":
            (value, dtype) = args
            return SymNode(
                self.tr, "cast", np.dtype(dtype), (self.tr.lift(value),)
            )
        if name == "broadcast":
            return self.tr.lift(args[0])
        fn = _NATIVE.get(name)
        if fn is None:
            raise BridgeUnsupported(f"builtin '{name}' has no GTIR counterpart")
        return SymNode(self.tr, "call", fn, tuple(self.tr.lift(a) for a in args))


def _to_expr(node: SymNode, memo: dict, defining: Optional[SymNode] = None) -> gtir.Expr:
    # shifted-composite temps read through their name; the defining
    # expression is emitted once as a statement
    if node.temp_name is not None and node is not defining:
        return gtir.FieldAccess(name=node.temp_name, offset=(0, 0, 0))
    key = id(node)
    hit = memo.get(key)
    if hit is not None:
        return hit
    k = node.kind
    if k == "field":
        name, off = node.data
        expr = gtir.FieldAccess(name=name, offset=tuple(off))
    elif k == "scalar":
        expr = gtir.ScalarAccess(name=node.data)
    elif k == "literal":
        value, dtype = node.data
        expr = gtir.Literal(value=value, dtype=np.dtype(dtype))
    elif k == "binop":
        expr = gtir.BinaryOp(
            op=_BINOPS[node.data],
            left=_to_expr(node.children[0], memo),
            right=_to_expr(node.children[1], memo),
        )
    elif k == "ternary":
        expr = gtir.TernaryOp(
            cond=_to_expr(node.children[0], memo),
            true_expr=_to_expr(node.children[1], memo),
            false_expr=_to_expr(node.children[2], memo),
        )
    elif k == "neg":
        expr = gtir.UnaryOp(
            op=gtir.UnaryOperator.NEG, expr=_to_expr(node.children[0], memo)
        )
    elif k == "not":
        expr = gtir.UnaryOp(
            op=gtir.UnaryOperator.NOT, expr=_to_expr(node.children[0], memo)
        )
    elif k == "call":
        expr = gtir.NativeFuncCall(
            func=node.data, args=[_to_expr(c, memo) for c in node.children]
        )
    elif k == "cast":
        expr = gtir.Cast(dtype=node.data, expr=_to_expr(node.children[0], memo))
    else:  # pragma: no cover
        raise BridgeUnsupported(f"node kind {k}")
    if node is not defining:
        memo[key] = expr
    return expr


def _scan_sections(forward: bool, first_body, rest_body):
    """The two-section interval split of a lowered scan: the init level at
    the marching end, the carry recurrence over the rest (shared by the
    direct scan path and the traced-composition path)."""
    if forward:
        return [
            gtir.VerticalSection(
                interval=gtir.Interval(
                    start=gtir.AxisBound.start(0), end=gtir.AxisBound.start(1)
                ),
                body=first_body,
            ),
            gtir.VerticalSection(
                interval=gtir.Interval(
                    start=gtir.AxisBound.start(1), end=gtir.AxisBound.end(0)
                ),
                body=rest_body,
            ),
        ]
    return [
        gtir.VerticalSection(
            interval=gtir.Interval(
                start=gtir.AxisBound.end(-1), end=gtir.AxisBound.end(0)
            ),
            body=first_body,
        ),
        gtir.VerticalSection(
            interval=gtir.Interval(
                start=gtir.AxisBound.start(0), end=gtir.AxisBound.end(-1)
            ),
            body=rest_body,
        ),
    ]


def _rename_field(loops, old: str, new: str) -> None:
    """Rename every FieldAccess of ``old`` to ``new`` across the loops
    (used to write a scan's output directly into the API out field)."""
    from gt4py_tpu import eve

    for loop in loops:
        for section in loop.sections:
            for stmt in section.body:
                for node in eve.walk_values(stmt):
                    if isinstance(node, gtir.FieldAccess) and node.name == old:
                        node.name = new


@dataclasses.dataclass
class BridgeVariant:
    backend: Any  # cartesian Backend instance
    dims: tuple  # (I_dim | None, J_dim | None, K_dim | None)
    field_params: list  # (name, dims-mask, axis permutation)
    scalar_params: list  # (name,)
    out_name: str  # single out (field operators); scans use out_names
    out_names: tuple = ()  # tuple-carry scans: one out field per leaf


def _dim_map(field_args: dict) -> dict:
    horizontals: list[Dimension] = []
    vertical: list[Dimension] = []
    for f in field_args.values():
        for nr in f.domain.ranges:
            d = nr.dim
            if d.kind == DimensionKind.HORIZONTAL:
                if d not in horizontals:
                    horizontals.append(d)
            elif d.kind == DimensionKind.VERTICAL:
                if d not in vertical:
                    vertical.append(d)
            else:
                raise BridgeUnsupported(f"LOCAL dimension {d} (unstructured)")
    if len(horizontals) > 2 or len(vertical) > 1:
        raise BridgeUnsupported("more dimensions than the cartesian I/J/K")
    dim_axis: dict = {}
    dims = [None, None, None]
    for i, d in enumerate(horizontals):
        dim_axis[d] = i
        dims[i] = d
    if vertical:
        dim_axis[vertical[0]] = 2
        dims[2] = vertical[0]
    return dim_axis, tuple(dims)


def build_variant(
    definition: Callable,
    field_args: dict,
    scalar_args: dict,
    out,
    providers: Optional[dict],
    backend_name: str,
    gtir_transform: Optional[Callable] = None,
) -> BridgeVariant:
    """Trace the definition on symbolic values and compile it as a
    cartesian stencil for ``backend_name``.

    ``gtir_transform`` (``Stencil -> Stencil``) hooks the lowered GTIR
    just before analysis — the mid-level test point for bridge output
    (e.g. the textual double-roundtrip
    ``lambda s: gtir_pretty.parse(gtir_pretty.pretty(s))``; reference
    program_processors/runners/double_roundtrip.py role, one level BELOW
    the FOAST round-trip in next/foast_pretty.py)."""
    from gt4py_tpu.cartesian.backend.base import REGISTRY
    from gt4py_tpu.cartesian.passes.pipeline import analyze_gtir

    dim_axis, dims = _dim_map(field_args)
    out_dtype = np.dtype(out.dtype)
    float_dtype = out_dtype if out_dtype.kind == "f" else np.dtype(np.float64)
    tr = _Tracer(dim_axis, providers or {}, float_dtype)

    sym_args = {}
    field_params = []
    for name, f in field_args.items():
        mask = [False, False, False]
        perm = []
        for nr in f.domain.ranges:
            mask[dim_axis[nr.dim]] = True
        # permutation: array axes ordered by their (I, J, K) slot
        order = sorted(range(len(f.domain.ranges)), key=lambda i: dim_axis[f.domain.ranges[i].dim])
        perm = tuple(order)
        sym_args[name] = SymNode(tr, "field", (name, (0, 0, 0)), ())
        field_params.append((name, tuple(mask), perm))
    for name in scalar_args:
        sym_args[name] = SymNode(tr, "scalar", name, ())

    k_dim = next((d for d, ax in dim_axis.items() if ax == 2), None)
    if k_dim is not None and k_dim in out.domain:
        rr = out.domain[k_dim].unit_range
        tr.k_range = (rr.start, rr.stop)

    result = definition(**sym_args)
    if not isinstance(result, SymNode):
        raise BridgeUnsupported("operator result is not a single field expression")

    out_name = "__bridge_out"
    # Direct scan result: rename the scan's output temporary to the out
    # field so the sequential loop writes the API field directly (no
    # full-field copy loop).
    rename = None
    if (
        result.kind == "field"
        and result.temp_name is None
        and result.data[0] in tr.scan_out_names
        and tuple(result.data[1]) == (0, 0, 0)
    ):
        rename = result.data[0]
    if rename is not None:
        tr.flush_parallel()
        _rename_field(tr.loops, rename, out_name)
        tr.scan_out_names.remove(rename)
    else:
        tr.flush_parallel(final_assign=(out_name, result))

    params: list[gtir.Decl] = []
    for name, mask, _ in field_params:
        params.append(
            gtir.FieldDecl(
                name=name, dtype=np.dtype(field_args[name].dtype), dimensions=mask
            )
        )
    out_mask = [False, False, False]
    for nr in out.domain.ranges:
        if nr.dim not in dim_axis:
            raise BridgeUnsupported(f"out dimension {nr.dim} not used by any input")
        out_mask[dim_axis[nr.dim]] = True
    params.append(
        gtir.FieldDecl(name=out_name, dtype=out_dtype, dimensions=tuple(out_mask))
    )
    for name, value in scalar_args.items():
        params.append(gtir.ScalarDecl(name=name, dtype=np.dtype(type(value))))

    stencil = gtir.Stencil(
        name=getattr(definition, "__name__", "bridged_operator"),
        params=params,
        vertical_loops=list(tr.loops),
        temporaries=[gtir.Temporary(name=t.temp_name) for t in tr.temps]
        + [gtir.Temporary(name=n) for n in tr.scan_out_names],
    )
    if gtir_transform is not None:
        stencil = gtir_transform(stencil)
    analyzed = analyze_gtir(stencil, {"backend": backend_name})
    backend = REGISTRY[backend_name](analyzed, {})
    return BridgeVariant(
        backend=backend,
        dims=dims,
        field_params=field_params,
        scalar_params=sorted(scalar_args),
        out_name=out_name,
    )


def build_scan_variant(
    op: Any,
    field_args: dict,
    scalar_args: dict,
    out,
    providers: Optional[dict],
    backend_name: str,
    gtir_transform: Optional[Callable] = None,
) -> BridgeVariant:
    """Lower a ``scan_operator`` onto the cartesian sequential-K path (the
    K-sweep kernel that serves FORWARD/BACKWARD stencils on ``gpu``).

    The per-level definition ``f(carry, *args) -> carry`` is traced twice on
    :class:`SymNode` placeholders: once with the init value (the first-level
    section) and once with the carry bound to an offset read of the out
    field(s) at k∓1 (the remaining levels) — producing exactly the
    two-section sequential vertical loop of a hand-written GTScript scan.
    Reference correspondence: foast_to_gtir's scan lowering
    (/root/reference/src/gt4py/next/ffront/foast_to_gtir.py:123-148) into
    gtfn ScanExecution (codegens/gtfn/codegen.py:181-208)."""
    import jax

    from gt4py_tpu.cartesian.backend.base import REGISTRY
    from gt4py_tpu.cartesian.passes.pipeline import analyze_gtir
    from gt4py_tpu.next.embedded import Field

    out_fields = list(out) if isinstance(out, (tuple, list)) else [out]
    if not all(isinstance(f, Field) for f in out_fields):
        raise BridgeUnsupported("scan out is not a Field (or tuple of Fields)")
    init_leaves = jax.tree_util.tree_leaves(op.init)
    if len(init_leaves) != len(out_fields):
        raise BridgeUnsupported("scan init / out structure mismatch")
    for v in init_leaves:
        if not isinstance(v, (bool, int, float, np.integer, np.floating, np.bool_)):
            raise BridgeUnsupported("non-scalar scan init")

    dim_axis, dims = _dim_map(field_args)
    if dims[2] is None or dim_axis.get(op.axis) != 2:
        raise BridgeUnsupported("scan axis is not the vertical (K) dimension")
    out0 = out_fields[0]
    out_dtype = np.dtype(out0.dtype)
    float_dtype = out_dtype if out_dtype.kind == "f" else np.dtype(np.float64)
    tr = _Tracer(dim_axis, providers or {}, float_dtype)
    if op.axis in out0.domain:
        rr = out0.domain[op.axis].unit_range
        tr.k_range = (rr.start, rr.stop)

    field_params = []
    arg_nodes = {}
    for name, f in field_args.items():
        mask = [False, False, False]
        for nr in f.domain.ranges:
            mask[dim_axis[nr.dim]] = True
        order = sorted(
            range(len(f.domain.ranges)),
            key=lambda i: dim_axis[f.domain.ranges[i].dim],
        )
        arg_nodes[name] = SymNode(tr, "field", (name, (0, 0, 0)), ())
        field_params.append((name, tuple(mask), tuple(order)))
    scalar_nodes = {n: SymNode(tr, "scalar", n, ()) for n in scalar_args}

    out_names = tuple(f"__bridge_out_{i}" for i in range(len(out_fields)))
    forward = bool(op.forward)
    dk = -1 if forward else 1

    def trace_section(carry_leaves) -> list[gtir.Stmt]:
        carry = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(op.init), carry_leaves
        )
        sig = inspect.signature(op.definition)
        names = list(sig.parameters)
        call_args = []
        for n in names[1:]:
            if n in arg_nodes:
                call_args.append(arg_nodes[n])
            elif n in scalar_nodes:
                call_args.append(scalar_nodes[n])
            else:
                raise BridgeUnsupported(f"unbound scan parameter '{n}'")
        from gt4py_tpu.next.foast import exec_definition

        result = exec_definition(op)(carry, *call_args)
        leaves = jax.tree_util.tree_leaves(
            result, is_leaf=lambda x: isinstance(x, SymNode)
        )
        if len(leaves) != len(out_fields) or not all(
            isinstance(v, SymNode) for v in leaves
        ):
            raise BridgeUnsupported("scan result structure mismatch")
        memo: dict = {}
        body: list[gtir.Stmt] = []
        new_temps = [t for t in tr.temps if t.temp_name not in _emitted]
        for tnode in new_temps:
            body.append(
                gtir.Assign(
                    target=gtir.FieldAccess(name=tnode.temp_name, offset=(0, 0, 0)),
                    value=_to_expr(tnode, memo, defining=tnode),
                )
            )
            _emitted.add(tnode.temp_name)
        for oname, node in zip(out_names, leaves):
            body.append(
                gtir.Assign(
                    target=gtir.FieldAccess(name=oname, offset=(0, 0, 0)),
                    value=_to_expr(tr.lift(node), memo),
                )
            )
        return body

    _emitted: set = set()
    first_body = trace_section([tr.lift(v) for v in init_leaves])
    carry_reads = [
        SymNode(tr, "field", (oname, (0, 0, dk)), ()) for oname in out_names
    ]
    rest_body = trace_section(carry_reads)
    sections = _scan_sections(forward, first_body, rest_body)

    params: list[gtir.Decl] = []
    for name, mask, _ in field_params:
        params.append(
            gtir.FieldDecl(
                name=name, dtype=np.dtype(field_args[name].dtype), dimensions=mask
            )
        )
    for oname, of in zip(out_names, out_fields):
        omask = [False, False, False]
        for nr in of.domain.ranges:
            if nr.dim not in dim_axis:
                raise BridgeUnsupported(f"out dimension {nr.dim} not used by any input")
            omask[dim_axis[nr.dim]] = True
        if not omask[2]:
            raise BridgeUnsupported("scan out field lacks the scan axis")
        params.append(
            gtir.FieldDecl(
                name=oname, dtype=np.dtype(of.dtype), dimensions=tuple(omask)
            )
        )
    for name, value in scalar_args.items():
        params.append(gtir.ScalarDecl(name=name, dtype=np.dtype(type(value))))

    stencil = gtir.Stencil(
        name=getattr(op.definition, "__name__", "bridged_scan"),
        params=params,
        vertical_loops=[
            gtir.VerticalLoop(
                loop_order=(
                    gtir.LoopOrder.FORWARD if forward else gtir.LoopOrder.BACKWARD
                ),
                sections=sections,
            )
        ],
        temporaries=[gtir.Temporary(name=t.temp_name) for t in tr.temps],
    )
    if gtir_transform is not None:
        stencil = gtir_transform(stencil)
    analyzed = analyze_gtir(stencil, {"backend": backend_name})
    backend = REGISTRY[backend_name](analyzed, {})
    return BridgeVariant(
        backend=backend,
        dims=dims,
        field_params=field_params,
        scalar_params=sorted(scalar_args),
        out_name=out_names[0],
        out_names=out_names,
    )


def signature_key(field_args, scalar_args, out, providers, backend_name):
    parts = [backend_name]
    for name, f in field_args.items():
        parts.append((name, tuple(nr.dim for nr in f.domain.ranges), str(f.dtype)))
    for name, v in scalar_args.items():
        parts.append((name, np.dtype(type(v)).str))
    parts.append(("out", tuple(nr.dim for nr in out.domain.ranges), str(out.dtype)))
    # Pin the vertical out range: concat_where boundary coordinates
    # resolve against it at trace time, so a different K window must
    # rebuild the variant (trace+analyze only; kernels are per-domain
    # cached downstream anyway).
    for nr in out.domain.ranges:
        if nr.dim.kind == DimensionKind.VERTICAL:
            parts.append(("out_k", nr.unit_range.start, nr.unit_range.stop))
    if providers:
        parts.append(tuple(sorted((k, repr(v)) for k, v in providers.items())))
    return tuple(parts)


def execute(variant: BridgeVariant, field_args, scalar_args, out):
    import jax.numpy as jnp

    dims = variant.dims
    if variant.out_names:
        outs = list(
            zip(variant.out_names, out if isinstance(out, (tuple, list)) else [out])
        )
    else:
        outs = [(variant.out_name, out)]
    out0 = outs[0][1]
    # compute domain from the out field's domain
    domain = [1, 1, 1]
    out_axis_of = {}
    for i, nr in enumerate(out0.domain.ranges):
        for ax in range(3):
            if dims[ax] == nr.dim:
                domain[ax] = len(nr.unit_range)
                out_axis_of[ax] = nr
    arrays = {}
    origins = {}
    for name, mask, perm in variant.field_params:
        f = field_args[name]
        arr = jnp.asarray(f.ndarray)
        if perm != tuple(range(len(perm))):
            arr = jnp.transpose(arr, perm)
        arrays[name] = arr
        o = [0, 0, 0]
        for ax in range(3):
            if not mask[ax]:
                continue
            f_start = f.domain[dims[ax]].unit_range.start
            o_start = out_axis_of[ax].unit_range.start if ax in out_axis_of else f_start
            shift = o_start - f_start
            if shift < 0:
                raise BridgeUnsupported(
                    f"field '{name}' does not cover the out domain on {dims[ax]}"
                )
            o[ax] = int(shift)
        origins[name] = tuple(o)
    for oname, of in outs:
        arrays[oname] = jnp.asarray(of.ndarray)
        origins[oname] = (0, 0, 0)

    pinfos = variant.backend.analyzed.parameter_infos
    scalars = {
        n: np.asarray(v, dtype=pinfos[n].dtype)[()] if n in pinfos else v
        for n, v in scalar_args.items()
    }
    result = variant.backend.run(arrays, scalars, tuple(domain), origins)
    for oname, of in outs:
        of.ndarray = result[oname]


def try_call(op, args, kwargs, out, providers) -> bool:
    """Route a field-operator call through the cartesian kernels; returns
    False when the operator/signature is outside the cartesian subset."""
    from gt4py_tpu.next.embedded import Field

    try:
        sig = inspect.signature(op.definition)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
    except TypeError:
        return False
    field_args = {}
    scalar_args = {}
    for name, value in bound.arguments.items():
        if isinstance(value, Field):
            field_args[name] = value
        elif isinstance(value, (int, float, np.integer, np.floating, bool)):
            scalar_args[name] = value
        else:
            return False
    if not field_args or out is None or not isinstance(out, Field):
        return False

    cache = getattr(op, "_bridge_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(op, "_bridge_cache", cache)
    try:
        key = signature_key(field_args, scalar_args, out, providers, op.backend)
    except BridgeUnsupported:
        return False
    variant = cache.get(key)
    if variant is None:
        if key in cache:
            return False
        try:
            from gt4py_tpu.next.foast import exec_definition

            variant = build_variant(
                exec_definition(op), field_args, scalar_args, out, providers,
                op.backend,
            )
        except BridgeUnsupported:
            cache[key] = None
            return False
        cache[key] = variant
    if variant is None:
        return False
    try:
        execute(variant, field_args, scalar_args, out)
        return True
    except BridgeUnsupported:
        cache[key] = None
        return False


def try_call_scan(op, args, kwargs, out, providers) -> bool:
    """Route a scan-operator call onto the cartesian sequential-K kernels;
    returns False when the call is outside the bridgeable subset (tuple
    fields, LOCAL dims, non-scalar init, domain mismatches, ...)."""
    from gt4py_tpu.next.embedded import Field

    sig = inspect.signature(op.definition)
    names = list(sig.parameters)
    if not names:
        return False
    try:
        bound = sig.bind(None, *args, **kwargs)  # None = carry placeholder
        bound.apply_defaults()
    except TypeError:
        return False
    field_args = {}
    scalar_args = {}
    for name, value in bound.arguments.items():
        if name == names[0]:
            continue
        if isinstance(value, Field):
            field_args[name] = value
        elif isinstance(value, (int, float, np.integer, np.floating, bool)):
            scalar_args[name] = value
        else:
            return False
    if not field_args or out is None:
        return False
    out_fields = list(out) if isinstance(out, (tuple, list)) else [out]
    if not all(isinstance(f, Field) for f in out_fields):
        return False

    cache = op.__dict__.setdefault("_bridge_cache", {})
    try:
        key = signature_key(
            field_args, scalar_args, out_fields[0], providers, op.backend
        ) + (
            ("scan", op.axis, bool(op.forward), repr(op.init), len(out_fields)),
        )
    except BridgeUnsupported:
        return False
    variant = cache.get(key)
    if variant is None:
        if key in cache:
            return False
        try:
            variant = build_scan_variant(
                op, field_args, scalar_args, out, providers, op.backend
            )
        except BridgeUnsupported:
            cache[key] = None
            return False
        cache[key] = variant
    try:
        execute(variant, field_args, scalar_args, out)
        return True
    except BridgeUnsupported:
        cache[key] = None
        return False
