"""Unit tests for the analysis passes (reference pattern:
tests/cartesian_tests/unit_tests/test_gtc/ — IR-level pass tests)."""

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtir
from gt4py_tpu.cartesian.definitions import AccessKind
from gt4py_tpu.cartesian.frontend import GTScriptSyntaxError
from gt4py_tpu.cartesian.passes import analyze

from . import stencil_defs as defs


def opts(**kw):
    base = dict(backend="numpy", externals={}, dtypes={})
    base.update(kw)
    return base


def test_hdiff_extents():
    """The classic extent cascade: out(0) → flx/fly(-1..0/+0..1) →
    lap(-1..1) → in_field(-2..2). (Inlining disabled so the cascade through
    temporaries is observable.)"""
    analyzed = analyze(
        defs.horizontal_diffusion,
        opts(backend_opts={"inline_temporaries": False}),
    )
    fe = analyzed.field_extents
    assert fe["in_field"].i == (-2, 2) and fe["in_field"].j == (-2, 2)
    assert fe["lap_field"].i == (-1, 1) and fe["lap_field"].j == (-1, 1)
    assert fe["flx_field"].i == (-1, 0)
    assert fe["fly_field"].j == (0, 0) or fe["fly_field"].j == (-1, 0)
    info = analyzed.field_infos["in_field"]
    assert info.boundary.lower[:2] == (2, 2)
    assert info.boundary.upper[:2] == (2, 2)
    assert analyzed.field_infos["out_field"].boundary.lower == (0, 0, 0)


def test_access_kinds():
    analyzed = analyze(defs.horizontal_diffusion, opts())
    assert analyzed.field_infos["in_field"].access == AccessKind.READ
    assert analyzed.field_infos["out_field"].access == AccessKind.WRITE
    assert analyzed.field_infos["coeff"].access == AccessKind.READ


def test_tridiagonal_k_boundaries_and_min_size():
    analyzed = analyze(defs.tridiagonal_solver, opts())
    # interval(1, None) reads [0,0,-1]: in-domain, no K halo demanded.
    assert analyzed.field_infos["rhs"].boundary.lower[2] == 0
    assert analyzed.domain_info.min_sequential_axis_size == 1


def test_large_k_interval_min_size():
    analyzed = analyze(defs.large_k_interval, opts())
    assert analyzed.domain_info.min_sequential_axis_size == 16


def test_vadv_k_upper_boundary():
    """wcon is read at [1, 0, 1] in the first interval → I upper halo 1;
    K reads stay inside the domain."""
    analyzed = analyze(
        defs.vertical_advection_dycore, opts(externals=defs.VADV_EXTERNALS)
    )
    assert analyzed.field_infos["wcon"].boundary.upper[0] == 1
    assert analyzed.field_infos["u_stage"].boundary.lower[2] == 0


def test_lowering_produces_masked_assigns():
    analyzed = analyze(defs.runtime_if, opts())
    stmts = [s for _, _, s in analyzed.stencil.walk_stmts()]
    # mask temp assignments + masked writes; no structured Ifs remain
    assert all(isinstance(s, (gtir.Assign, gtir.While)) for s in stmts)
    masked = [s for s in stmts if isinstance(s, gtir.Assign) and s.mask is not None]
    assert len(masked) == 4  # 2 writes per branch


def test_dtype_inference_and_casts():
    analyzed = analyze(defs.temporary_stencil, opts())
    temp = {t.name: t for t in analyzed.stencil.temporaries}["tmp"]
    assert temp.dtype == np.float64


from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval  # noqa: E402


def test_definitive_assignment_rejected():
    def bad(a: defs.Field3D):
        with computation(PARALLEL), interval(...):
            if a > 0.0:
                t = 1.0
            a = t  # t only assigned on one branch

    with pytest.raises(GTScriptSyntaxError, match="read before assignment"):
        analyze(bad, opts())


def test_if_else_definite_assignment_accepted():
    def good(a: defs.Field3D):
        with computation(PARALLEL), interval(...):
            if a > 0.0:
                t = 1.0
            else:
                t = 2.0
            a = t

    analyze(good, opts())  # must not raise


def test_inline_temporaries_collapses_hdiff():
    """OnTheFlyMerging equivalent with a recompute-volume cap: hdiff's
    single-use chains (res/flx/fly) inline away, while the laplacian —
    read at 4 shifted points — stays materialized (computed once instead
    of 4 shifted recomputes); the
    in_field halo requirement is unchanged."""
    analyzed = analyze(defs.horizontal_diffusion, opts())
    stmts = [s for _, _, s in analyzed.stencil.walk_stmts()]
    assert len(stmts) == 2
    assert [t.name for t in analyzed.stencil.temporaries] == ["lap_field"]
    assert analyzed.field_infos["in_field"].boundary.lower[:2] == (2, 2)
    assert analyzed.field_infos["in_field"].boundary.upper[:2] == (2, 2)


def test_inlining_preserves_sequential_loops():
    analyzed = analyze(defs.tridiagonal_solver, opts())
    # No parallel defs: statement count unchanged (2+2+1+1 sections stmts).
    stmts = [s for _, _, s in analyzed.stencil.walk_stmts()]
    assert len(stmts) == 6


# --- race detection (reference lang_design.rst:55-88) -------------------------


def test_shifted_self_assignment_rejected():
    import pytest
    from gt4py_tpu.cartesian.passes.race_detection import StencilRaceError

    def bad(a: defs.Field3D):
        with computation(PARALLEL), interval(...):
            a = a[1, 0, 0]

    with pytest.raises(StencilRaceError, match="assigned from itself"):
        analyze(bad, opts())


def test_write_after_offset_read_rejected_in_parallel():
    import pytest
    from gt4py_tpu.cartesian.passes.race_detection import StencilRaceError

    def bad(a: defs.Field3D, b: defs.Field3D):
        with computation(PARALLEL), interval(...):
            b = a[1, 0, 0]
            a = b[0, 0, 0]

    with pytest.raises(StencilRaceError, match="written .* after being read|written\nafter|written"):
        analyze(bad, opts())


def test_k_self_read_allowed_in_forward():
    # dcol[0,0,-1]-style carries are the DEFINED sequential semantics.
    def ok(a: defs.Field3D):
        with computation("FORWARD"):
            with interval(0, 1):
                a = a[0, 0, 0] * 1.0
            with interval(1, None):
                a = a[0, 0, -1] + 1.0

    analyze(ok, opts())


def test_write_then_offset_read_allowed():
    # write first, offset-read later: reads observe updated values.
    def ok(a: defs.Field3D, b: defs.Field3D):
        with computation(PARALLEL), interval(...):
            b = a[0, 0, 0] * 2.0
            a = b[1, 0, 0]

    analyze(ok, opts())


# --- vector/matmul unrolling (round-3; reference defir_to_gtir.py:123,195) ---


def test_vector_assignment_unrolls_to_components():
    import numpy as np

    from gt4py_tpu.cartesian import gtir, gtscript
    from gt4py_tpu.cartesian.frontend import parse_stencil
    from gt4py_tpu.cartesian.passes.lowering import lower_control_flow
    from gt4py_tpu.cartesian.passes.vector_unroll import unroll_vector_assignments

    Vec3 = gtscript.Field[(np.float64, (3,))]
    Mat33 = gtscript.Field[(np.float64, (3, 3))]

    def s(mat: Mat33, vec: Vec3, out: Vec3):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = mat @ vec

    ir = unroll_vector_assignments(lower_control_flow(parse_stencil(s, {})))
    body = ir.vertical_loops[0].sections[0].body
    assert len(body) == 3  # one scalar assignment per component
    for c, stmt in enumerate(body):
        assert isinstance(stmt, gtir.Assign)
        (idx,) = stmt.target.data_index
        assert isinstance(idx, gtir.Literal) and idx.value == c
        # value is a 3-term sum of mat[c, j] * vec[j]
        muls = [
            n
            for n in __import__("gt4py_tpu").eve.walk_values(stmt.value)
            if isinstance(n, gtir.BinaryOp)
            and n.op == gtir.ArithmeticOperator.MUL
        ]
        assert len(muls) == 3


def test_unroll_caps_large_vectors():
    import numpy as np

    from gt4py_tpu.cartesian import gtir, gtscript
    from gt4py_tpu.cartesian.frontend import parse_stencil
    from gt4py_tpu.cartesian.passes.lowering import lower_control_flow
    from gt4py_tpu.cartesian.passes.vector_unroll import unroll_vector_assignments

    Big = gtscript.Field[(np.float64, (32,))]

    def s(a: Big, out: Big):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = a * 2.0

    ir = unroll_vector_assignments(lower_control_flow(parse_stencil(s, {})))
    body = ir.vertical_loops[0].sections[0].body
    assert len(body) == 1  # above the cap: whole-vector form retained
    assert not body[0].target.data_index


def test_unroll_keeps_aliased_matmul_atomic():
    """`v = mat @ v` must NOT unroll: later components would read already
    overwritten earlier ones (review-confirmed wrong-results regression)."""
    import numpy as np

    from gt4py_tpu.cartesian import gtscript

    Vec3 = gtscript.Field[(np.float64, (3,))]
    Mat33 = gtscript.Field[(np.float64, (3, 3))]

    def s(mat: Mat33, v: Vec3):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            v = mat @ v

    rng = np.random.default_rng(0)
    mat = rng.random((2, 2, 1, 3, 3))
    v0 = rng.random((2, 2, 1, 3))
    expected = np.einsum("...ij,...j->...i", mat, v0)
    for backend in ("numpy", "jax"):
        st = gtscript.stencil(
            backend=backend, definition=s, name=f"aliasmm_{backend}", rebuild=True
        )
        v = v0.copy()
        st(mat.copy(), v)
        np.testing.assert_allclose(v, expected, rtol=1e-12, err_msg=backend)

    # elementwise self-reads still unroll (y = a*x + y)
    from gt4py_tpu.cartesian.frontend import parse_stencil
    from gt4py_tpu.cartesian.passes.lowering import lower_control_flow
    from gt4py_tpu.cartesian.passes.vector_unroll import unroll_vector_assignments

    def axpy(x: Vec3, y: Vec3):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            y = x * 2.0 + y

    ir = unroll_vector_assignments(lower_control_flow(parse_stencil(axpy, {})))
    assert len(ir.vertical_loops[0].sections[0].body) == 3
