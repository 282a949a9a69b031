"""Field-operator -> cartesian-kernel bridge (SURVEY §7 step 8): the
structured subset of the field-view DSL executes through the cartesian
``gpu`` backend (XLA, and the K-sweep kernel for scans); results must
match the embedded oracle exactly."""

import numpy as np
import pytest

import gt4py_tpu.next as gtx
from gt4py_tpu.next import Dimension, DimensionKind, FieldOffset, neighbor_sum, where

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)
Ioff = FieldOffset("Ioff", source=IDim, target=(IDim,))
Joff = FieldOffset("Joff", source=JDim, target=(JDim,))
PROV = {"Ioff": IDim, "Joff": JDim}


@pytest.fixture
def rng():
    return np.random.default_rng(12)


@gtx.field_operator
def lap(phi):
    return -4.0 * phi + phi(Ioff[1]) + phi(Ioff[-1]) + phi(Joff[1]) + phi(Joff[-1])


def test_bridge_lap_matches_embedded(rng):
    n = 12
    data = rng.random((n, n, 4))
    phi = gtx.as_field([IDim, JDim, KDim], data)

    out_e = gtx.zeros({IDim: (1, n - 1), JDim: (1, n - 1), KDim: 4})
    lap.with_backend(None)(phi, out=out_e, offset_provider=PROV)

    out_p = gtx.zeros({IDim: (1, n - 1), JDim: (1, n - 1), KDim: 4})
    op = lap.with_backend("gpu")
    op(phi, out=out_p, offset_provider=PROV)
    assert op._bridge_cache and all(v is not None for v in op._bridge_cache.values())
    np.testing.assert_allclose(out_p.asnumpy(), out_e.asnumpy(), rtol=1e-13)


@gtx.field_operator
def hdiff_op(inp, coeff):
    lap_f = 4.0 * inp - (inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1]))
    res1 = lap_f(Ioff[1]) - lap_f
    flx = where(res1 * (inp(Ioff[1]) - inp) > 0.0, 0.0, res1)
    res2 = lap_f(Joff[1]) - lap_f
    fly = where(res2 * (inp(Joff[1]) - inp) > 0.0, 0.0, res2)
    return inp - coeff * (flx - flx(Ioff[-1]) + fly - fly(Joff[-1]))


def test_bridge_hdiff_matches_embedded(rng):
    n = 16
    data = rng.random((n, n, 3))
    co = rng.random((n, n, 3))
    inp = gtx.as_field([IDim, JDim, KDim], data)
    coeff = gtx.as_field([IDim, JDim, KDim], co)
    dom = {IDim: (2, n - 2), JDim: (2, n - 2), KDim: 3}

    out_e = gtx.zeros(dom)
    hdiff_op.with_backend(None)(inp, coeff, out=out_e, offset_provider=PROV)

    op = hdiff_op.with_backend("gpu")
    out_p = gtx.zeros(dom)
    op(inp, coeff, out=out_p, offset_provider=PROV)
    assert all(v is not None for v in op._bridge_cache.values())
    np.testing.assert_allclose(out_p.asnumpy(), out_e.asnumpy(), rtol=1e-12)


def test_bridge_scalar_params_and_math(rng):
    from gt4py_tpu.next.fbuiltins import sqrt

    @gtx.field_operator
    def damp(a, b, alpha: float):
        return sqrt(abs(a)) * alpha + where(b > 0.5, a, -a)

    n = 10
    a = gtx.as_field([IDim, JDim], rng.random((n, n)))
    b = gtx.as_field([IDim, JDim], rng.random((n, n)))
    dom = {IDim: n, JDim: n}
    out_e = gtx.zeros(dom)
    damp.with_backend(None)(a, b, 1.5, out=out_e, offset_provider={})
    op = damp.with_backend("gpu")
    out_p = gtx.zeros(dom)
    op(a, b, 1.5, out=out_p, offset_provider={})
    assert all(v is not None for v in op._bridge_cache.values())
    np.testing.assert_allclose(out_p.asnumpy(), out_e.asnumpy(), rtol=1e-13)


def test_bridge_nested_operator_calls(rng):
    @gtx.field_operator
    def laplap(phi):
        return lap(lap(phi))

    n = 14
    data = rng.random((n, n))
    phi = gtx.as_field([IDim, JDim], data)
    dom = {IDim: (2, n - 2), JDim: (2, n - 2)}
    out_e = gtx.zeros(dom)
    laplap.with_backend(None)(phi, out=out_e, offset_provider=PROV)
    op = laplap.with_backend("gpu")
    out_p = gtx.zeros(dom)
    op(phi, out=out_p, offset_provider=PROV)
    assert all(v is not None for v in op._bridge_cache.values())
    np.testing.assert_allclose(out_p.asnumpy(), out_e.asnumpy(), rtol=1e-12)


def test_unstructured_falls_back_to_embedded(rng):
    """Connectivity offsets are outside the bridge: the embedded path must
    serve them (and still be correct)."""
    from tests.next_tests.test_field_ops import make_periodic_mesh

    V = Dimension("Vertex")
    E = Dimension("Edge")
    V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
    E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)
    V2E = FieldOffset("V2E", source=E, target=(V, V2EDim))
    E2V = FieldOffset("E2V", source=V, target=(E, E2VDim))

    @gtx.field_operator
    def nabla(pp, s_x, sign, vol):
        zavg = 0.5 * (pp(E2V[0]) + pp(E2V[1])) * s_x
        return neighbor_sum(zavg(V2E) * sign, axis=V2EDim) / vol

    n = 4
    e2v_np, v2e_np, signs_np = make_periodic_mesh(n)
    nv, ne = n * n, 2 * n * n
    pp = gtx.as_field([V], rng.random(nv))
    s_x = gtx.as_field([E], rng.random(ne))
    sign = gtx.as_field([V, V2EDim], signs_np)
    vol = gtx.as_field([V], rng.random(nv) + 0.5)
    e2v = gtx.as_connectivity([E, E2VDim], V, e2v_np)
    v2e = gtx.as_connectivity([V, V2EDim], E, v2e_np)
    out = gtx.zeros({V: nv})
    nabla.with_backend("gpu")(
        pp, s_x, sign, vol, out=out, offset_provider={"E2V": e2v, "V2E": v2e}
    )
    zavg = 0.5 * (pp.asnumpy()[e2v_np[:, 0]] + pp.asnumpy()[e2v_np[:, 1]]) * s_x.asnumpy()
    expected = (zavg[v2e_np] * signs_np).sum(axis=1) / vol.asnumpy()
    np.testing.assert_allclose(out.asnumpy(), expected, rtol=1e-12)


# --- scan_operator bridging (scans onto the K-sweep kernel, reference
# foast_to_gtir.py:123-148) --------------------------------------------------


def _bridged(op) -> bool:
    cache = getattr(op, "_bridge_cache", None)
    return bool(cache) and any(v is not None for v in cache.values())


def _staged(op) -> bool:
    """The bridged stencil's last call ran the K-sweep kernel (in the
    Pallas interpreter on the CPU test platform)."""
    for v in (getattr(op, "_bridge_cache", None) or {}).values():
        if v is not None:
            return getattr(v.backend, "last_kernel", None) == "triton-interpret"
    return False


def test_scan_bridge_cumsum(rng):
    @gtx.scan_operator(axis=KDim, forward=True, init=0.0, backend="gpu")
    def cumsum(carry: float, a: float) -> float:
        return carry + a

    data = rng.random((6, 5, 8))
    a = gtx.as_field([IDim, JDim, KDim], data)
    out = gtx.zeros({IDim: 6, JDim: 5, KDim: 8})
    cumsum(a, out=out)
    np.testing.assert_allclose(
        np.asarray(out.ndarray), np.cumsum(data, axis=2), rtol=1e-12
    )
    assert _bridged(cumsum)
    assert _staged(cumsum), "scan must serve from the K-sweep kernel"


def test_scan_bridge_backward(rng):
    @gtx.scan_operator(axis=KDim, forward=False, init=0.0, backend="gpu")
    def back(carry: float, a: float) -> float:
        return carry * 0.5 + a

    data = rng.random((6, 5, 8))
    a = gtx.as_field([IDim, JDim, KDim], data)
    out = gtx.zeros({IDim: 6, JDim: 5, KDim: 8})
    back(a, out=out)
    exp = np.zeros_like(data)
    c = np.zeros((6, 5))
    for k in range(7, -1, -1):
        c = c * 0.5 + data[:, :, k]
        exp[:, :, k] = c
    np.testing.assert_allclose(np.asarray(out.ndarray), exp, rtol=1e-12)
    assert _bridged(back)


def test_scan_bridge_tuple_carry(rng):
    @gtx.scan_operator(
        axis=KDim, forward=True, init=(0.0, 1.0), backend="gpu"
    )
    def pair(carry: tuple, a: float) -> tuple:
        s, p = carry
        return (s + a, p * 0.9 + a)

    data = rng.random((6, 5, 8))
    a = gtx.as_field([IDim, JDim, KDim], data)
    o1 = gtx.zeros({IDim: 6, JDim: 5, KDim: 8})
    o2 = gtx.zeros({IDim: 6, JDim: 5, KDim: 8})
    pair(a, out=(o1, o2))
    exp2 = np.zeros_like(data)
    p = np.ones((6, 5))
    for k in range(8):
        p = p * 0.9 + data[:, :, k]
        exp2[:, :, k] = p
    np.testing.assert_allclose(
        np.asarray(o1.ndarray), np.cumsum(data, axis=2), rtol=1e-12
    )
    np.testing.assert_allclose(np.asarray(o2.ndarray), exp2, rtol=1e-12)
    assert _bridged(pair)


def test_scan_bridge_scalar_param_and_where(rng):
    @gtx.scan_operator(axis=KDim, forward=True, init=0.0, backend="gpu")
    def damped(carry: float, a: float, alpha: float) -> float:
        return where(a > 0.5, carry * alpha + a, carry)

    data = rng.random((6, 5, 8))
    a = gtx.as_field([IDim, JDim, KDim], data)
    out = gtx.zeros({IDim: 6, JDim: 5, KDim: 8})
    damped(a, 0.7, out=out)
    exp = np.zeros_like(data)
    c = np.zeros((6, 5))
    for k in range(8):
        c = np.where(data[:, :, k] > 0.5, c * 0.7 + data[:, :, k], c)
        exp[:, :, k] = c
    np.testing.assert_allclose(np.asarray(out.ndarray), exp, rtol=1e-12)
    assert _bridged(damped)


def test_scan_bridge_matches_embedded_oracle(rng):
    """Same scan through embedded (backend=None) and the bridge."""

    def defn(carry: float, a: float, b: float) -> float:
        return carry * 0.8 + a * b

    bridged_op = gtx.scan_operator(
        axis=KDim, forward=True, init=0.0, backend="gpu"
    )(defn)
    embedded_op = gtx.scan_operator(axis=KDim, forward=True, init=0.0, backend=None)(
        defn
    )

    da = rng.random((5, 4, 7))
    db = rng.random((5, 4, 7))
    a = gtx.as_field([IDim, JDim, KDim], da)
    b = gtx.as_field([IDim, JDim, KDim], db)
    out_b = gtx.zeros({IDim: 5, JDim: 4, KDim: 7})
    out_e = gtx.zeros({IDim: 5, JDim: 4, KDim: 7})
    bridged_op(a, b, out=out_b)
    embedded_op(a, b, out=out_e)
    np.testing.assert_allclose(
        np.asarray(out_b.ndarray), np.asarray(out_e.ndarray), rtol=1e-12
    )
    assert _bridged(bridged_op)


def test_scan_bridge_kless_arg_broadcasts(rng):
    """An IJ (K-less) argument broadcasts across levels inside the scan."""

    @gtx.scan_operator(axis=KDim, forward=True, init=0.0, backend="gpu")
    def acc(carry: float, a: float, w: float) -> float:
        return carry + a * w

    data = rng.random((6, 5, 8))
    wdata = rng.random((6, 5))
    a = gtx.as_field([IDim, JDim, KDim], data)
    w = gtx.as_field([IDim, JDim], wdata)
    out = gtx.zeros({IDim: 6, JDim: 5, KDim: 8})
    acc(a, w, out=out)
    np.testing.assert_allclose(
        np.asarray(out.ndarray),
        np.cumsum(data * wdata[:, :, None], axis=2),
        rtol=1e-12,
    )
    assert _bridged(acc)


# --- fused scan compositions: field_operators containing scan calls ----------
# The scan calls inline as sequential vertical loops of ONE cartesian
# stencil (scan outputs = temporaries -> register carries in the K-sweep
# kernel), the reference's lift-inlining-into-ScanExecution architecture
# (codegens/gtfn/itir_to_gtfn_ir.py).

Koff = gtx.FieldOffset("Koff", source=KDim, target=(KDim,))
PROV_K = {"Ioff": IDim, "Joff": JDim, "Koff": KDim}


@gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
def _tri_fwd(carry, a: float, b: float, c: float, d: float):
    cp_prev, dp_prev = carry
    denom = b - a * cp_prev
    return (c / denom, (d - a * dp_prev) / denom)


@gtx.scan_operator(axis=KDim, forward=False, init=0.0)
def _tri_bwd(x_kp1, cp: float, dp: float):
    return dp - cp * x_kp1


@gtx.field_operator(backend="gpu")
def solve_tridiag(a, b, c, d):
    cp, dp = _tri_fwd(a, b, c, d)
    return _tri_bwd(cp, dp)


def test_fused_tridiag_composition(rng):
    from tests.cartesian_tests import stencil_defs as defs

    shape = (8, 9, 8)
    inf = -np.ones(shape)
    diag = np.full(shape, 4.0)
    sup = -np.ones(shape)
    rhs = rng.random(shape)
    expected = defs.validate_tridiagonal_solver(inf, diag, sup, rhs)

    out = gtx.zeros({IDim: 8, JDim: 9, KDim: 8})
    solve_tridiag(
        gtx.as_field([IDim, JDim, KDim], inf),
        gtx.as_field([IDim, JDim, KDim], diag),
        gtx.as_field([IDim, JDim, KDim], sup),
        gtx.as_field([IDim, JDim, KDim], rhs),
        out=out,
    )
    np.testing.assert_allclose(np.asarray(out.ndarray), expected, rtol=1e-10)
    var = next(v for v in solve_tridiag._bridge_cache.values() if v is not None)
    assert var.backend.last_kernel == "triton-interpret"
    orders = [vl.loop_order.name for vl in var.backend.analyzed.stencil.vertical_loops]
    assert orders == ["FORWARD", "BACKWARD"], orders


BET_M, BET_P = 0.5, 0.5


@gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
def _vadv_fwd(
    carry, w_i1, w_c, w_i1_k1, w_k1, us_m1, us, us_p1, upos, uten, utens_st,
    kidx, klast, dtr,
):
    ccol_m1, dcol_m1 = carry
    first = kidx == 0
    last = kidx == klast
    gav = -0.25 * (w_i1 + w_c)
    gcv = 0.25 * (w_i1_k1 + w_k1)
    as_ = where(first, 0.0, gav * BET_M)
    acol = where(first, 0.0, gav * BET_P)
    cs = where(last, 0.0, gcv * BET_M)
    ccol = where(last, 0.0, gcv * BET_P)
    bcol = dtr - acol - ccol
    corr = -as_ * (us_m1 - us) - cs * (us_p1 - us)
    dcol = dtr * upos + uten + utens_st + corr
    divided = 1.0 / (bcol - ccol_m1 * acol)
    return (ccol * divided, (dcol - dcol_m1 * acol) * divided)


@gtx.scan_operator(axis=KDim, forward=False, init=(0.0, 0.0))
def _vadv_bwd(carry, ccol, dcol, upos, kidx, klast, dtr):
    data_p1, _ = carry
    data = where(kidx == klast, dcol, dcol - ccol * data_p1)
    return (data, dtr * (data - upos))


@gtx.field_operator(backend="gpu")
def next_vadv(utens_stage, u_stage, wcon, u_pos, utens, kidx, klast: int, dtr: float):
    ccol, dcol = _vadv_fwd(
        wcon(Ioff[1]), wcon, wcon(Ioff[1])(Koff[1]), wcon(Koff[1]),
        u_stage(Koff[-1]), u_stage, u_stage(Koff[1]),
        u_pos, utens, utens_stage, kidx, klast, dtr,
    )
    return _vadv_bwd(ccol, dcol, u_pos, kidx, klast, dtr)[1]


def test_fused_vadv_composition(rng):
    """Field-view vadv (two scans + K/I-shifted args + boundary selection
    via a K index field) against the cartesian NumPy column oracle."""
    from tests.cartesian_tests import stencil_defs as defs

    ni, nj, nk = 7, 6, 9
    utens_stage = rng.random((ni, nj, nk))
    u_stage = rng.random((ni, nj, nk))
    wcon = rng.random((ni, nj, nk))
    u_pos = rng.random((ni, nj, nk))
    utens = rng.random((ni, nj, nk))
    dtr_stage = 3.0 / 20.0
    expected = defs.validate_vertical_advection_dycore(
        utens_stage, u_stage, wcon, u_pos, utens, dtr_stage
    )

    as3 = lambda a: gtx.as_field([IDim, JDim, KDim], a)  # noqa: E731
    kidx = gtx.as_field([KDim], np.arange(nk, dtype=np.int32))
    out = gtx.zeros({IDim: ni - 1, JDim: nj, KDim: nk})
    next_vadv(
        as3(utens_stage), as3(u_stage), as3(wcon), as3(u_pos), as3(utens),
        kidx, nk - 1, dtr_stage,
        out=out, offset_provider=PROV_K,
    )
    np.testing.assert_allclose(np.asarray(out.ndarray), expected, rtol=1e-10)
    var = next(v for v in next_vadv._bridge_cache.values() if v is not None)
    assert var.backend.last_kernel == "triton-interpret"
    orders = [vl.loop_order.name for vl in var.backend.analyzed.stencil.vertical_loops]
    assert orders == ["FORWARD", "BACKWARD"], orders


# --- round-3 review regressions ---------------------------------------------


def test_scan_bridge_2d_field_falls_back_correctly(rng):
    """A scan over an (I, K) field (no J) must produce correct results —
    via the bridge if supported, via fallback otherwise, never a crash."""

    @gtx.scan_operator(axis=KDim, forward=True, init=0.0, backend="gpu")
    def cum2d(carry: float, a: float) -> float:
        return carry + a

    data = rng.random((6, 8))
    a = gtx.as_field([IDim, KDim], data)
    out = gtx.zeros({IDim: 6, KDim: 8})
    cum2d(a, out=out)
    np.testing.assert_allclose(
        np.asarray(out.ndarray), np.cumsum(data, axis=1), rtol=1e-12
    )


def test_traced_scan_call_with_kwargs(rng):
    """Scans called with keyword arguments inside a traced composition."""

    @gtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def kcum(carry: float, a: float) -> float:
        return carry + a

    @gtx.field_operator(backend="gpu")
    def op(a):
        return kcum(a=a)

    data = rng.random((5, 4, 6))
    a = gtx.as_field([IDim, JDim, KDim], data)
    out = gtx.zeros({IDim: 5, JDim: 4, KDim: 6})
    op(a, out=out)
    np.testing.assert_allclose(
        np.asarray(out.ndarray), np.cumsum(data, axis=2), rtol=1e-12
    )


def test_composite_scan_args_dependency_order(rng):
    """Composite scan arguments referencing each other must materialize in
    dependency order (diag = f(lower, upper) with upper registered later
    used to trip definitive assignment)."""

    @gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
    def fwd(carry, a: float, b: float, c: float, d: float):
        cp_prev, dp_prev = carry
        denom = b - a * cp_prev
        return (c / denom, (d - a * dp_prev) / denom)

    @gtx.scan_operator(axis=KDim, forward=False, init=0.0)
    def bwd(x_kp1, cp: float, dp: float):
        return dp - cp * x_kp1

    @gtx.field_operator(backend="gpu")
    def solve(q, kappa, kidx, klast: int, r: float):
        lower = where(kidx == 0, 0.0, -r * kappa)
        upper = where(kidx == klast, 0.0, -r * kappa)
        diag = 1.0 - lower - upper  # reads BOTH composites
        cp, dp = fwd(lower, diag, upper, q)
        return bwd(cp, dp)

    ni, nj, nk = 5, 4, 8
    q0 = rng.random((ni, nj, nk))
    kappa = 0.5 + 0.5 * rng.random((ni, nj, nk))
    r = 0.1
    kidx = gtx.as_field([KDim], np.arange(nk, dtype=np.int32))
    out = gtx.zeros({IDim: ni, JDim: nj, KDim: nk})
    solve(
        gtx.as_field([IDim, JDim, KDim], q0),
        gtx.as_field([IDim, JDim, KDim], kappa),
        kidx, nk - 1, r, out=out,
    )
    # dense oracle per column
    expected = np.empty_like(q0)
    for i in range(ni):
        for j in range(nj):
            m = np.zeros((nk, nk))
            for k in range(nk):
                lo = 0.0 if k == 0 else -r * kappa[i, j, k]
                up = 0.0 if k == nk - 1 else -r * kappa[i, j, k]
                m[k, k] = 1.0 - lo - up
                if k > 0:
                    m[k, k - 1] = lo
                if k < nk - 1:
                    m[k, k + 1] = up
            expected[i, j] = np.linalg.solve(m, q0[i, j])
    np.testing.assert_allclose(np.asarray(out.ndarray), expected, rtol=1e-10)
    assert _bridged(solve) and _staged(solve)


def test_scan_bridge_bool_carry_specializes(rng):
    """Constant-after-first carry leaves (the icon-like ``first_level``
    bool, reference test_icon_like_scan.py:43-53) fold out of the
    sequential sections: the lowered GTIR has straight-line sections, no
    ternaries, and no bool carry temp."""
    from typing import NamedTuple

    class State(NamedTuple):
        q: float
        w: float
        first: bool

    @gtx.scan_operator(axis=KDim, forward=True, init=State(0.0, 0.0, True))
    def sc(state: State, w: float, q: float, a: float, b: float, c: float) -> State:
        g = b + a * state.q
        qn = (0.0 - c) * g
        wn = a * state.w * g
        return (
            State(q=q, w=w, first=False)
            if state.first
            else State(q=qn, w=wn, first=False)
        )

    @gtx.field_operator(backend="gpu")
    def solve(w, q, a, b, c):
        qr, wr, dummy = sc(w, q, a, b, c)
        return qr + wr

    ni, nj, nk = 5, 4, 7
    data = {x: rng.random((ni, nj, nk)) for x in "wqabc"}
    f = {x: gtx.as_field([IDim, JDim, KDim], v) for x, v in data.items()}
    out = gtx.zeros({IDim: ni, JDim: nj, KDim: nk})
    solve(f["w"], f["q"], f["a"], f["b"], f["c"], out=out)

    var = next(v for v in solve._bridge_cache.values() if v is not None)
    from gt4py_tpu.cartesian.gtir_pretty import pretty

    text = pretty(var.backend.analyzed.stencil)
    assert "?" not in text and "where" not in text  # no ternaries survive
    assert "bool" not in text  # the bool carry temp is gone
    assert text.count("interval(") == 3  # first level + rest + out copy

    # numerics vs a per-column oracle
    zq = np.zeros((ni, nj, nk))
    zw = np.zeros((ni, nj, nk))
    qp = np.zeros((ni, nj))
    wp = np.zeros((ni, nj))
    for kk in range(nk):
        g = data["b"][..., kk] + data["a"][..., kk] * qp
        qn = -data["c"][..., kk] * g
        wn = data["a"][..., kk] * wp * g
        zq[..., kk] = data["q"][..., kk] if kk == 0 else qn
        zw[..., kk] = data["w"][..., kk] if kk == 0 else wn
        qp, wp = zq[..., kk], zw[..., kk]
    np.testing.assert_allclose(out.asnumpy(), zq + zw, rtol=1e-10)
