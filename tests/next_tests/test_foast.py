"""FOAST pipeline tests: lowering/codegen equivalence, the transform
passes (constant folding, DCE, CSE, unroll_reduce, extract_temporaries),
fallback honesty, and the user-facing knobs.

Reference analog: tests/next_tests/unit_tests/ffront_tests (func_to_foast,
foast_passes) + iterator transform tests (test_cse.py, test_unroll_reduce.py,
transforms pass_manager options). Execution-level equivalence is checked
against the raw definition (which the NumPy-oracle path always runs)."""

import numpy as np
import pytest

import gt4py_tpu.next as gtx
from gt4py_tpu.next import Dimension, DimensionKind, FieldOffset, neighbor_sum, where
from gt4py_tpu.next import foast, foast_passes
from gt4py_tpu.next.foast import TransformOptions

I = Dimension("I")
J = Dimension("J")
K = Dimension("K", kind=DimensionKind.VERTICAL)
Ioff = FieldOffset("Ioff", source=I, target=(I,))

V = Dimension("V")
E = Dimension("E")
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
V2E = FieldOffset("V2E", source=E, target=(V, V2EDim))

V2E_TABLE = np.array([[0, 3], [0, 1], [1, 2], [2, 3]])
V2E_SKIP_TABLE = np.array([[0, 3], [0, -1], [1, 2], [2, -1]])

CART_PROV = {"Ioff": I}


def vprov(skip=False):
    table = V2E_SKIP_TABLE if skip else V2E_TABLE
    return {
        "V2E": gtx.as_connectivity(
            [V, V2EDim], E, table, skip_value=(-1 if skip else None)
        )
    }


def ij_field(shape=(6, 5), seed=0):
    rng = np.random.default_rng(seed)
    return gtx.as_field([I, J], rng.uniform(-1, 1, size=shape))


def run_both(op, *args, out_domain, offset_provider=None, **kwargs):
    """Execute through FOAST (default) and raw (enabled=False); both must
    agree bit-for-bit — the pipeline's contract is observation equivalence."""
    out_a = gtx.zeros(out_domain)
    op(*args, out=out_a, offset_provider=offset_provider, **kwargs)
    out_b = gtx.zeros(out_domain)
    op.with_transforms(enabled=False)(
        *args, out=out_b, offset_provider=offset_provider, **kwargs
    )
    np.testing.assert_array_equal(out_a.asnumpy(), out_b.asnumpy())
    return out_a


# --- lowering + codegen equivalence over the construct matrix ---------------------


@gtx.field_operator
def _arith(a: gtx.Field[gtx.Dims[I, J], gtx.float64],
           b: gtx.Field[gtx.Dims[I, J], gtx.float64]):
    c = a * 2.0 - b / 3.0 + a % 2.0
    d = a ** 2.0 + (-b) + (+a)
    e = a // 1.0
    return c + d + e


@gtx.field_operator
def _logic(a: gtx.Field[gtx.Dims[I, J], gtx.float64],
           b: gtx.Field[gtx.Dims[I, J], gtx.float64]):
    m = (a > b) & (a >= 0.0) | ~(b < 0.0)
    eq = (a == b) != (a <= b)
    return where(m & eq, a, b)


@gtx.field_operator
def _shifted(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
    return a(Ioff[1]) - 2.0 * a + a(Ioff[2])


@gtx.field_operator
def _tuples(a: gtx.Field[gtx.Dims[I, J], gtx.float64],
            b: gtx.Field[gtx.Dims[I, J], gtx.float64]):
    pair = (a + b, a - b)
    s, d = pair
    swapped = (pair[1], pair[0])
    return s * swapped[0] + d * swapped[1]


@gtx.field_operator
def _calls(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
    t = gtx.maximum(a, 0.0)
    u = gtx.astype(a > 0.0, gtx.float64)
    return gtx.sqrt(t + 1.0) * u


@gtx.field_operator
def _ternary_scalar(a: gtx.Field[gtx.Dims[I, J], gtx.float64], flag: bool = True):
    v = a * 2.0 if flag else a * 3.0
    return v


@gtx.field_operator
def _with_default(a: gtx.Field[gtx.Dims[I, J], gtx.float64], w: float = 2.5):
    return a * w


@gtx.field_operator
def _inner(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
    return a + 1.0


@gtx.field_operator
def _nested_call(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
    return _inner(a) * _inner(a + 2.0)


@pytest.mark.parametrize(
    "op,n_args,ni",
    [(_arith, 2, 6), (_logic, 2, 6), (_shifted, 1, 4), (_tuples, 2, 6),
     (_calls, 1, 6), (_nested_call, 1, 6), (_with_default, 1, 6)],
    ids=["arith", "logic", "shifted", "tuples", "calls", "nested", "default"],
)
def test_equivalence_matrix(op, n_args, ni):
    args = [ij_field(seed=i) for i in range(n_args)]
    dom = {I: ni, J: 5}
    out = run_both(op, *args, out_domain=dom, offset_provider=CART_PROV)
    assert np.isfinite(out.asnumpy()).all()
    # and the executed path really was the FOAST-compiled form
    assert getattr(foast.exec_definition(op), "__gt_foast__", False)


def test_scalar_if_statement_and_ternary():
    # Python-level branching on a scalar requires the scalar to be a
    # declared STATIC parameter (baked into the executable variant) —
    # same rule as the raw trace-based path.
    @gtx.field_operator
    def op_def(a: gtx.Field[gtx.Dims[I, J], gtx.float64], mode: int = 1):
        if mode == 1:
            r = a * 10.0
        elif mode == 2:
            r = a * 20.0
        else:
            r = a
        return r

    op = op_def.with_compilation_options(static_params=("mode",))
    f = ij_field()
    for mode in (1, 2, 3):
        out = run_both(op, f, out_domain={I: 6, J: 5}, mode=mode)
        scale = {1: 10.0, 2: 20.0, 3: 1.0}[mode]
        np.testing.assert_allclose(out.asnumpy(), f.asnumpy() * scale)
    tern = _ternary_scalar.with_compilation_options(static_params=("flag",))
    run_both(tern, f, out_domain={I: 6, J: 5}, flag=True)
    run_both(tern, f, out_domain={I: 6, J: 5}, flag=False)


def test_kwonly_and_kwargs_call():
    @gtx.field_operator
    def op(a: gtx.Field[gtx.Dims[I, J], gtx.float64], *, gain: float = 3.0):
        return a * gain

    f = ij_field()
    out = gtx.zeros({I: 6, J: 5})
    op(f, out=out, gain=4.0)
    np.testing.assert_allclose(out.asnumpy(), f.asnumpy() * 4.0)
    out2 = gtx.zeros({I: 6, J: 5})
    op(f, out=out2)  # kw-only default preserved by the generated function
    np.testing.assert_allclose(out2.asnumpy(), f.asnumpy() * 3.0)


def test_augassign_and_multi_target():
    @gtx.field_operator
    def op(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
        x = y = a * 2.0
        x += 1.0
        x *= 2.0
        return x + y

    run_both(op, ij_field(), out_domain={I: 6, J: 5})


# --- pass-level tests -----------------------------------------------------------------


def _src(op, provider=None):
    from gt4py_tpu.next.embedded import offset_provider_context

    with offset_provider_context(provider):
        return foast.foast_source(op)


def test_constant_folding_in_source():
    @gtx.field_operator
    def op(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
        return a * (3.0 * 4.0 + 2.0 ** 2.0) + (10 // 3)

    src = _src(op)
    assert "16.0" in src and "3" in src
    assert "3.0 * 4.0" not in src and "//" not in src
    run_both(op, ij_field(), out_domain={I: 6, J: 5})


def test_constant_folding_overflow_guard():
    ir = foast_passes.fold_constants(
        foast.FieldOperatorDefinition(
            name="f", params=[],
            body=[foast.Return(value=foast.BinOp(
                op="*", left=foast.Literal(value=1e308),
                right=foast.Literal(value=10.0)))],
        )
    )
    # inf has no literal form: stays an expression
    assert isinstance(ir.body[0].value, foast.BinOp)


def test_dce_removes_unused():
    @gtx.field_operator
    def op(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
        dead = a * 123.456
        alive = a + 1.0
        dead2 = alive * dead
        return alive

    src = _src(op)
    assert "dead" not in src and "123.456" not in src
    run_both(op, ij_field(), out_domain={I: 6, J: 5})


def test_dce_respects_branches():
    @gtx.field_operator
    def op_def(a: gtx.Field[gtx.Dims[I, J], gtx.float64], flag: bool = True):
        x = a * 2.0
        if flag:
            r = x + 1.0
        else:
            r = a
        return r

    # x is live only through one branch: must survive
    assert "x = " in _src(op_def)
    op = op_def.with_compilation_options(static_params=("flag",))
    run_both(op, ij_field(), out_domain={I: 6, J: 5}, flag=True)
    run_both(op, ij_field(), out_domain={I: 6, J: 5}, flag=False)


def test_cse_hoists_shared_shift():
    @gtx.field_operator
    def op(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
        u = a(Ioff[1]) * 2.0
        v = a(Ioff[1]) * 3.0
        return u + v

    src = _src(op)
    assert src.count("a(Ioff[1])") == 1, src  # gathered once
    assert "__cse_" in src
    run_both(op, ij_field(), out_domain={I: 5, J: 5}, offset_provider=CART_PROV)


def test_cse_respects_reassignment():
    @gtx.field_operator
    def op(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
        u = a * 2.0
        a = a + 1.0
        v = a * 2.0  # different 'a': must NOT unify with u
        return u + v

    src = _src(op)
    assert "__cse_" not in src
    run_both(op, ij_field(), out_domain={I: 6, J: 5})


def test_cse_nested_prefers_outermost():
    @gtx.field_operator
    def op(a: gtx.Field[gtx.Dims[I, J], gtx.float64],
           b: gtx.Field[gtx.Dims[I, J], gtx.float64]):
        u = (a + b) * (a - b)
        v = (a + b) * (a - b) + 1.0
        return u * v

    src = _src(op)
    assert src.count("((a + b) * (a - b))") == 1, src
    run_both(op, ij_field(seed=1), ij_field(seed=2), out_domain={I: 6, J: 5})


def test_cse_does_not_hoist_across_branches():
    @gtx.field_operator
    def op_def(a: gtx.Field[gtx.Dims[I, J], gtx.float64], flag: bool = True):
        if flag:
            r = a * 7.0
        else:
            r = a * 7.0 + 1.0
        return r

    # With if-lowering off, the branches stay Python regions and CSE must
    # not hoist across them (hoisting would evaluate under the wrong
    # branch). With lowering ON, the functional region evaluates both
    # branches anyway, so sharing there is correct — only the preserved
    # plain-bool dispatch region must stay hoist-free.
    assert "__cse_" not in _src(op_def.with_transforms(lower_ifs=False))
    lowered = _src(op_def)
    plain_region = lowered.split("__gtx_is_plain_bool__")[1].split("else:")[0]
    assert "__cse_" not in plain_region
    op = op_def.with_compilation_options(static_params=("flag",))
    run_both(op, ij_field(), out_domain={I: 6, J: 5}, flag=True)


# --- unroll_reduce ---------------------------------------------------------------------


@gtx.field_operator
def _vsum(edges: gtx.Field[gtx.Dims[E], gtx.float64]):
    return neighbor_sum(edges(V2E) * 2.0, axis=V2EDim)


def test_unroll_reduce_numerics_and_source():
    edges = gtx.as_field([E], np.array([1.0, 10.0, 100.0, 1000.0]))
    expected = (np.array([1.0, 10.0, 100.0, 1000.0])[V2E_TABLE] * 2.0).sum(axis=1)

    out = gtx.zeros({V: 4})
    unrolled = _vsum.with_transforms(unroll_reduce=True)
    unrolled(edges, out=out, offset_provider=vprov())
    np.testing.assert_allclose(out.asnumpy(), expected)

    src = _src(unrolled, provider=vprov())
    assert "neighbor_sum" not in src
    assert "edges(V2E[0])" in src.replace("__cse_1", "edges") or "V2E[0]" in src
    assert "V2E[1]" in src


def test_unroll_reduce_blocked_by_skip_values():
    unrolled = _vsum.with_transforms(unroll_reduce=True)
    src = _src(unrolled, provider=vprov(skip=True))
    assert "neighbor_sum" in src  # masked remap path retained
    edges = gtx.as_field([E], np.array([1.0, 10.0, 100.0, 1000.0]))
    out = gtx.zeros({V: 4})
    unrolled(edges, out=out, offset_provider=vprov(skip=True))
    table = V2E_SKIP_TABLE
    vals = np.where(table >= 0, np.array([1.0, 10.0, 100.0, 1000.0])[table] * 2.0, 0.0)
    np.testing.assert_allclose(out.asnumpy(), vals.sum(axis=1))


def test_unroll_reduce_local_shifted_field():
    @gtx.field_operator
    def op(pp: gtx.Field[gtx.Dims[E], gtx.float64]):
        scaled = pp * 3.0
        return neighbor_sum(scaled(V2E), axis=V2EDim)

    unrolled = op.with_transforms(unroll_reduce=True)
    src = _src(unrolled, provider=vprov())
    assert "neighbor_sum" not in src  # local as SHIFT TARGET is fine
    edges = gtx.as_field([E], np.arange(4.0))
    out = run_both(unrolled, edges, out_domain={V: 4}, offset_provider=vprov())
    np.testing.assert_allclose(out.asnumpy(), (np.arange(4.0) * 3.0)[V2E_TABLE].sum(axis=1))


def test_unroll_reduce_blocked_by_neighbor_local():
    @gtx.field_operator
    def op(pp: gtx.Field[gtx.Dims[E], gtx.float64]):
        nb = pp(V2E)  # materialized neighbor field: carries V2EDim
        return neighbor_sum(nb + pp(V2E), axis=V2EDim)

    unrolled = op.with_transforms(unroll_reduce=True)
    src = _src(unrolled, provider=vprov())
    assert "neighbor_sum" in src  # blocked: 'nb' carries the axis
    edges = gtx.as_field([E], np.arange(4.0))
    run_both(unrolled, edges, out_domain={V: 4}, offset_provider=vprov())


def test_unroll_reduce_needs_provider_at_compile():
    # without a provider the pass is a no-op (dense remap retained)
    ir = foast.func_to_foast(_vsum.definition)
    out_ir, _ = foast_passes.apply_common_transforms(
        ir, TransformOptions(unroll_reduce=True),
        globals_ns=_vsum.definition.__globals__, closure={}, offset_provider=None,
    )
    assert "neighbor_sum" in foast.codegen(out_ir)


# --- extract_temporaries ------------------------------------------------------------------


def test_extract_temporaries_numerics_and_barrier():
    @gtx.field_operator
    def op(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
        t = a * 2.0 + 1.0
        u = t * t
        return u + t

    mat = op.with_transforms(extract_temporaries=True)
    src = _src(mat)
    assert "__gt_materialize__" in src
    out = run_both(mat, ij_field(), out_domain={I: 6, J: 5})
    # the barrier is visible in the traced program
    txt = mat.inspect(ij_field(), stage="jaxpr")
    assert "opt_barrier" in txt or "optimization_barrier" in txt


def test_extract_temporaries_numpy_identity():
    from gt4py_tpu.next.foast_passes import _materialize

    x = np.arange(4.0)
    assert _materialize(x) is x  # numpy trees pass through untouched


# --- fallback honesty + knobs ---------------------------------------------------------------


def test_fallback_reason_recorded():
    @gtx.field_operator
    def op(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
        acc = a
        for _ in range(2):  # loops are outside the FOAST subset
            acc = acc + a
        return acc

    out = gtx.zeros({I: 6, J: 5})
    op(ij_field(), out=out)  # still correct through the raw definition
    np.testing.assert_allclose(out.asnumpy(), ij_field().asnumpy() * 3.0)
    assert "statement For" in op.__dict__["foast_fallback_reason"]
    with pytest.raises(ValueError, match="outside the FOAST subset"):
        _src(op)


def test_transforms_disabled_runs_raw():
    raw = _arith.with_transforms(enabled=False)
    assert foast.exec_definition(raw) is _arith.definition


def test_options_are_immutable_and_replace():
    o = TransformOptions()
    o2 = o.replace(unroll_reduce=True)
    assert o.unroll_reduce is False and o2.unroll_reduce is True
    with pytest.raises(Exception):
        o.unroll_reduce = True


def test_inspect_foast_stage():
    src = _arith.inspect(stage="foast")
    assert src.startswith("def _arith(")


def test_closure_captured_operator():
    scale = 7.0

    def make():
        @gtx.field_operator
        def op(a: gtx.Field[gtx.Dims[I, J], gtx.float64]):
            return a * scale

        return op

    op = make()
    out = gtx.zeros({I: 6, J: 5})
    f = ij_field()
    op(f, out=out)
    np.testing.assert_allclose(out.asnumpy(), f.asnumpy() * 7.0)


def test_generated_function_shares_live_globals():
    # FOAST functions resolve module globals LIVE (no stale snapshot) when
    # the definition has no closure cells.
    fn = foast.exec_definition(_arith)
    assert fn.__globals__ is _arith.definition.__globals__


# --- scan operators through the FOAST pipeline ----------------------------------------


@gtx.scan_operator(axis=K, forward=True, init=0.0)
def _cumsum(carry: gtx.float64, x: gtx.float64):
    dead = x - carry  # noqa: F841  (DCE candidate)
    k = 2.0 * 0.5  # folds to 1.0
    return carry + x * k


def test_scan_body_through_foast():
    src = foast.exec_definition(_cumsum).__gt_foast_source__
    assert "dead" not in src and "1.0" in src
    f = gtx.as_field([K], np.arange(6.0))
    out = gtx.zeros({K: 6})
    _cumsum(f, out=out)
    np.testing.assert_allclose(out.asnumpy(), np.cumsum(np.arange(6.0)))


def test_scan_with_transforms_disabled_matches():
    f = gtx.as_field([I, K], np.random.default_rng(3).uniform(-1, 1, (4, 7)))
    out_a = gtx.zeros({I: 4, K: 7})
    out_b = gtx.zeros({I: 4, K: 7})
    _cumsum(f, out=out_a)
    _cumsum.with_transforms(enabled=False)(f, out=out_b)
    np.testing.assert_array_equal(out_a.asnumpy(), out_b.asnumpy())


def test_scan_cse_in_tuple_carry_body():
    @gtx.scan_operator(axis=K, forward=False, init=(0.0, 0.0))
    def op(carry: tuple, x: gtx.float64):
        s = carry[0] + x * 2.0
        t = carry[1] - x * 2.0  # x * 2.0 is CSE'd across the two uses
        return (s, t)

    src = foast.exec_definition(op).__gt_foast_source__
    assert "__cse_1" in src
    f = gtx.as_field([K], np.arange(5.0))
    out = (gtx.zeros({K: 5}), gtx.zeros({K: 5}))
    op(f, out=out)
    rev = np.arange(5.0)[::-1]
    np.testing.assert_allclose(out[0].asnumpy(), (2 * rev).cumsum()[::-1])
    np.testing.assert_allclose(out[1].asnumpy(), (-2 * rev).cumsum()[::-1])


def test_scan_numpy_oracle_runs_raw_definition():
    # The oracle path must execute the untouched definition so oracle
    # comparisons double as FOAST-equivalence checks.
    f = gtx.as_field([K], np.arange(6.0))
    out = gtx.zeros({K: 6})
    _cumsum.with_backend("numpy")(f, out=out)
    np.testing.assert_allclose(out.asnumpy(), np.cumsum(np.arange(6.0)))


def test_bridged_scan_composition_uses_foast_form():
    # A field operator containing a scan call traces through the cartesian
    # bridge; the scan body runs in its FOAST form there (dead statements
    # must not break the symbolic trace and results must match embedded).
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def acc(carry: gtx.float64, x: gtx.float64):
        waste = carry * 3.0  # noqa: F841
        return carry + x

    @gtx.field_operator
    def op(a: gtx.Field[gtx.Dims[I, J, K], gtx.float64]):
        return acc(a) * 2.0

    rng = np.random.default_rng(11)
    f = gtx.as_field([I, J, K], rng.uniform(-1, 1, (6, 5, 8)))
    out_jax = gtx.zeros({I: 6, J: 5, K: 8})
    op(f, out=out_jax)
    out_pl = gtx.zeros({I: 6, J: 5, K: 8})
    op.with_backend("gpu")(f, out=out_pl)
    expect = 2 * np.cumsum(f.asnumpy(), axis=2)
    np.testing.assert_allclose(out_jax.asnumpy(), expect, rtol=1e-12)
    np.testing.assert_allclose(out_pl.asnumpy(), expect, rtol=1e-12)
