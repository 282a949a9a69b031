"""``gpu`` backend tests: the canonical stencils through the full
StencilObject path, compared with the NumPy oracles. On the CPU test
platform the K-sweep kernel runs in the Pallas interpreter, so the
sequential solvers report ``exec_info["kernel"] == "triton-interpret"``;
everything else is served by XLA (``"xla"``)."""

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript

from . import stencil_defs as defs


def build(definition, **kwargs):
    return gtscript.stencil(
        backend="gpu", definition=definition, rebuild=True, **kwargs
    )


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def test_copy(rng):
    st = build(defs.copy_stencil)
    a = rng.random((16, 16, 4))
    b = np.zeros((16, 16, 4))
    st(a, b)
    np.testing.assert_allclose(a, b)


def test_hdiff(rng):
    st = build(defs.horizontal_diffusion)
    shape = (20, 19, 4)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out_field = np.zeros(shape)
    st(
        in_field, out_field, coeff,
        origin=(2, 2, 0), domain=(shape[0] - 4, shape[1] - 4, shape[2]),
    )
    np.testing.assert_allclose(
        out_field[2:-2, 2:-2], defs.validate_horizontal_diffusion(in_field, coeff)
    )


def test_tridiagonal(rng):
    st = build(defs.tridiagonal_solver)
    shape = (8, 9, 8)
    inf = -np.ones(shape)
    diag = np.full(shape, 4.0)
    sup = -np.ones(shape)
    rhs = rng.random(shape)
    expected = defs.validate_tridiagonal_solver(inf, diag, sup, rhs)
    out = np.zeros(shape)
    exec_info = {}
    st(inf.copy(), diag.copy(), sup.copy(), rhs.copy(), out, exec_info=exec_info)
    assert exec_info["kernel"] == "triton-interpret"
    np.testing.assert_allclose(out, expected, rtol=1e-12)


def test_vadv(rng):
    st = build(defs.vertical_advection_dycore, externals=defs.VADV_EXTERNALS)
    shape = (6, 5, 9)
    utens_stage = rng.random(shape)
    u_stage = rng.random(shape)
    wcon = rng.random(shape)
    u_pos = rng.random(shape)
    utens = rng.random(shape)
    dtr_stage = 3.0 / 20.0
    expected = defs.validate_vertical_advection_dycore(
        utens_stage, u_stage, wcon, u_pos, utens, dtr_stage
    )
    result = utens_stage.copy()
    exec_info = {}
    st(
        result, u_stage, wcon, u_pos, utens,
        dtr_stage=dtr_stage, domain=(shape[0] - 1, shape[1], shape[2]),
        exec_info=exec_info,
    )
    assert exec_info["kernel"] == "triton-interpret"
    np.testing.assert_allclose(result[: shape[0] - 1], expected, rtol=1e-8)


def test_runtime_if(rng):
    st = build(defs.runtime_if)
    a = rng.random((8, 8, 3)) - 0.5
    b = np.zeros_like(a)
    exp_a, exp_b = defs.validate_runtime_if(a)
    st(a, b)
    np.testing.assert_allclose(a, exp_a)
    np.testing.assert_allclose(b, exp_b)


def test_while(rng):
    """A while loop in a BACKWARD loop has no plane-scan form: it runs
    level by level on XLA."""
    st = build(defs.while_stencil)
    a = rng.random((6, 6, 2)) * 4.0
    b = np.zeros_like(a)
    exp_a, exp_b = defs.validate_while(a, b)
    exec_info = {}
    st(a, b, exec_info=exec_info)
    assert exec_info["kernel"] == "xla"
    np.testing.assert_allclose(a, exp_a)
    np.testing.assert_allclose(b, exp_b)


def test_while_parallel_plane(rng):
    """PARALLEL while loops run on XLA."""
    from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

    F = gtscript.Field[np.float64]

    def grow(a: F, b: F):
        with computation(PARALLEL), interval(...):
            while a < 8.0:
                while b < 4.0:
                    b = b + 1.0
                a = a + b

    st = build(grow)
    a = rng.random((6, 6, 3)) * 10.0
    b = rng.random((6, 6, 3)) * 5.0
    exp_a, exp_b = a.copy(), b.copy()
    for i in np.ndindex(exp_a.shape):
        while exp_a[i] < 8.0:
            while exp_b[i] < 4.0:
                exp_b[i] += 1.0
            exp_a[i] += exp_b[i]
    exec_info = {}
    st(a, b, exec_info=exec_info)
    assert exec_info["kernel"] == "xla"
    np.testing.assert_allclose(a, exp_a)
    np.testing.assert_allclose(b, exp_b)


def test_region(rng):
    from .test_features import region_stencil

    st = build(region_stencil)
    a = np.zeros((9, 7, 2))
    st(a)
    expected = np.zeros_like(a)
    expected[0, :, :] = 10.0
    expected[-1, 0:2, :] = 20.0
    np.testing.assert_allclose(a, expected)


def test_region_hardware_shape_floor(rng):
    """A horizontal region inside a FORWARD section keeps the section off
    the K-sweep kernel (tiles do not know their global position); the
    whole stencil runs on XLA and stays correct."""
    from gt4py_tpu.cartesian.backend import ksweep_triton
    from gt4py_tpu.cartesian.backend.evaluator import Evaluator

    st = build(defs.region_in_sequential)
    inp = rng.random((6, 5, 7))
    out = np.zeros_like(inp)
    exec_info = {}
    st(inp, out, exec_info=exec_info)
    assert exec_info["kernel"] == "xla"
    expected = np.cumsum(inp, axis=2)
    expected[0, :, 1:] = 0.0
    np.testing.assert_allclose(out, expected)

    ev = Evaluator(
        st._analyzed, (6, 5, 7), {"inp": (0, 0, 0), "out": (0, 0, 0)},
        {"inp": inp, "out": out}, {}, ns="jax",
    )
    loop = ev.stencil.vertical_loops[-1]
    plan = ev._plane_plan(loop.sections[-1], backward=False)
    assert ksweep_triton.unsupported(ev, plan) == "horizontal region"


def test_variable_k_served_by_tiled_kernel(rng):
    """Variable K offsets gather along K on XLA."""
    from .test_features import var_k_stencil

    st = build(var_k_stencil)
    a = rng.random((4, 4, 6))
    idx = rng.integers(-2, 3, (4, 4, 6))
    out = np.zeros((4, 4, 6))
    exec_info = {}
    st(a, idx, out, exec_info=exec_info)
    assert exec_info["kernel"] == "xla"
    kk = np.clip(np.arange(6)[None, None, :] + idx, 0, 5)
    np.testing.assert_allclose(out, np.take_along_axis(a, kk, axis=2))


def test_global_table_served_natively(rng):
    from .test_features import table_lookup_plain

    st = build(table_lookup_plain)
    table = np.array([10.0, 20.0, 30.0, 40.0])
    idx = rng.integers(0, 4, (3, 3, 2))
    out = np.zeros((3, 3, 2))
    exec_info = {}
    st(idx, out, table, exec_info=exec_info)
    assert exec_info["kernel"] == "xla"
    np.testing.assert_allclose(out, table[idx])


def test_data_dims_served_natively(rng):
    """Data-dimension fields run on XLA without a warning (see
    test_pallas_dims.py for the lower-dim/data-dim matrix)."""
    import warnings

    from .test_features import data_dims_stencil

    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        st = build(data_dims_stencil)
        vec = rng.random((3, 3, 2, 3))
        out = np.zeros((3, 3, 2))
        exec_info = {}
        st(vec, out, exec_info=exec_info)
    assert exec_info["kernel"] == "xla"
    np.testing.assert_allclose(out, vec[..., 0] + 2 * vec[..., 1] + 3 * vec[..., 2])


def test_fallback_for_unsupported(rng):
    """A write to a lower-dim field from a K-spanning loop runs on XLA
    like every construct the kernel does not take, without a warning."""
    import warnings

    from .test_features import Field3D, FieldIJ

    def write_surf(a: Field3D, surf: FieldIJ):
        with computation(PARALLEL), interval(0, 1):
            surf = a[0, 0, 0]

    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        st = build(write_surf)
        a = rng.random((4, 4, 3))
        surf = np.zeros((4, 4))
        exec_info = {}
        st(a, surf, exec_info=exec_info)
    assert exec_info["kernel"] == "xla"
    np.testing.assert_allclose(surf, a[:, :, 0])


def test_k_blocked_parallel(rng):
    """K-interval sections of a PARALLEL loop: XLA serves them, each
    interval on its own rows."""
    st = build(defs.large_k_interval)
    shape = (16, 16, 20)
    in_field = rng.random(shape)
    out_field = np.zeros(shape)
    exec_info = {}
    st(in_field, out_field, exec_info=exec_info)
    assert exec_info["kernel"] == "xla"
    expected = in_field.copy()
    expected[:, :, 6:10] += 1
    np.testing.assert_allclose(out_field, expected)


def test_hdiff_k_blocked(rng):
    """hdiff over more levels than the K-sweep block: PARALLEL work is
    XLA's shifted-slice fusion."""
    st = build(defs.horizontal_diffusion)
    shape = (20, 19, 12)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out_field = np.zeros(shape)
    exec_info = {}
    st(
        in_field, out_field, coeff,
        origin=(2, 2, 0), domain=(shape[0] - 4, shape[1] - 4, shape[2]),
        exec_info=exec_info,
    )
    assert exec_info["kernel"] == "xla"
    np.testing.assert_allclose(
        out_field[2:-2, 2:-2], defs.validate_horizontal_diffusion(in_field, coeff)
    )


def test_lap3d_staged_parallel():
    """PARALLEL stencil WITH K offsets on ``gpu``, validated against the
    jax backend."""
    import numpy as np

    from gt4py_tpu import storage
    from gt4py_tpu.cartesian import gtscript

    F = gtscript.Field[np.float64]

    def lap3d(inp: F, out: F):
        with gtscript.computation("PARALLEL"), gtscript.interval(1, -1):
            out = -6.0 * inp[0, 0, 0] + (
                inp[1, 0, 0] + inp[-1, 0, 0]
                + inp[0, 1, 0] + inp[0, -1, 0]
                + inp[0, 0, 1] + inp[0, 0, -1]
            )

    rng = np.random.default_rng(3)
    shape = (18, 20, 10)
    data = rng.random(shape)

    results = {}
    for backend in ("jax", "gpu"):
        st = gtscript.stencil(backend=backend, definition=lap3d, name=f"lap3d_{backend}")
        a = storage.from_array(data, backend=backend)
        o = storage.zeros(shape, backend=backend)
        st(a, o, origin=(1, 1, 0), domain=(16, 18, 10))
        results[backend] = np.asarray(o)
    np.testing.assert_allclose(results["gpu"], results["jax"], rtol=1e-13)
    # interior K only: boundary planes untouched
    np.testing.assert_array_equal(results["gpu"][:, :, 0], 0.0)


def test_k_halo_parallel_reads(rng):
    """PARALLEL full-interval stencil reading inp[0, 0, ±1] with K origin 1:
    the K-halo planes must be read, not clamped domain-boundary planes."""
    from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

    F = gtscript.Field[np.float64]

    def kavg(inp: F, out: F):
        with computation(PARALLEL), interval(...):
            out = (inp[0, 0, -1] + inp[0, 0, 1]) * 0.5

    shape = (8, 9, 6)
    inp = rng.random(shape)
    domain, origin = (8, 9, 4), (0, 0, 1)
    out_p = np.zeros(shape)
    out_n = np.zeros(shape)
    build(kavg)(inp, out_p, origin=origin, domain=domain)
    gtscript.stencil(backend="numpy", definition=kavg, rebuild=True)(
        inp.copy(), out_n, origin=origin, domain=domain
    )
    np.testing.assert_allclose(out_p, out_n)
    # halo planes really were used
    np.testing.assert_allclose(
        out_p[:, :, 1], (inp[:, :, 0] + inp[:, :, 2]) * 0.5
    )


def test_split_forward_carry_seed(rng):
    """A FORWARD loop whose carried read targets a plane written by a
    PREVIOUS stage (cumsum split into two computations): the kernel's
    carry starts from the level the previous loop wrote."""
    from gt4py_tpu.cartesian.gtscript import FORWARD, computation, interval

    F = gtscript.Field[np.float64]

    def split_cumsum(inp: F, out: F):
        with computation(FORWARD), interval(0, 1):
            out = inp
        with computation(FORWARD), interval(1, None):
            out = out[0, 0, -1] + inp

    shape = (8, 9, 7)
    inp = rng.random(shape)
    out = np.zeros(shape)
    exec_info = {}
    build(split_cumsum)(inp, out, exec_info=exec_info)
    assert exec_info["kernel"] == "triton-interpret"
    np.testing.assert_allclose(out, np.cumsum(inp, axis=2), rtol=1e-12)


def test_split_forward_carry_seed_temporary(rng):
    """Same as above with the accumulator as a cross-stage TEMPORARY."""
    from gt4py_tpu.cartesian.gtscript import FORWARD, PARALLEL, computation, interval

    F = gtscript.Field[np.float64]

    def split_cumsum_temp(inp: F, out: F):
        with computation(FORWARD), interval(0, 1):
            acc = inp
        with computation(FORWARD), interval(1, None):
            acc = acc[0, 0, -1] + inp
        with computation(PARALLEL), interval(...):
            out = acc

    shape = (8, 9, 7)
    inp = rng.random(shape)
    out = np.zeros(shape)
    exec_info = {}
    build(split_cumsum_temp)(inp, out, exec_info=exec_info)
    assert exec_info["kernel"] == "triton-interpret"
    np.testing.assert_allclose(out, np.cumsum(inp, axis=2), rtol=1e-12)


def test_split_backward_carry_seed(rng):
    """BACKWARD variant of the cross-stage carried read."""
    from gt4py_tpu.cartesian.gtscript import BACKWARD, computation, interval

    F = gtscript.Field[np.float64]

    def split_rcumsum(inp: F, out: F):
        with computation(BACKWARD), interval(-1, None):
            out = inp
        with computation(BACKWARD), interval(0, -1):
            out = out[0, 0, 1] + inp

    shape = (8, 9, 7)
    inp = rng.random(shape)
    out = np.zeros(shape)
    build(split_rcumsum)(inp, out)
    np.testing.assert_allclose(
        out, np.cumsum(inp[:, :, ::-1], axis=2)[:, :, ::-1], rtol=1e-12
    )


def test_parallel_write_then_k_offset_read(rng):
    """A PARALLEL loop writing a field then reading it at a K offset in a
    later section must observe the UPDATED value (reference
    statement-stage semantics, permitted by the race pass)."""
    from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

    F = gtscript.Field[np.float64]

    def wtr(inp: F, a: F, out: F):
        with computation(PARALLEL):
            with interval(...):
                a = inp + 1.0
            with interval(0, -1):
                out = a[0, 0, 1]

    shape = (8, 9, 6)
    inp = rng.random(shape)
    a_p, out_p = np.zeros(shape), np.zeros(shape)
    a_n, out_n = np.zeros(shape), np.zeros(shape)
    build(wtr)(inp, a_p, out_p)
    gtscript.stencil(backend="numpy", definition=wtr, rebuild=True)(
        inp.copy(), a_n, out_n
    )
    np.testing.assert_allclose(a_p, a_n)
    np.testing.assert_allclose(out_p, out_n)
    np.testing.assert_allclose(out_p[:, :, 0], inp[:, :, 1] + 1.0)


def test_flagship_stencils_serve_from_native_strategies(rng):
    """The benchmark workloads are served by the path meant for them:
    the vertical solvers by the K-sweep kernel, horizontal and
    K-halo PARALLEL stencils by XLA. ``exec_info["kernel"]`` records it."""

    def run(definition, arrays, scalars=None, externals=None, **call_kw):
        st = gtscript.stencil(
            backend="gpu", definition=definition, rebuild=True,
            externals=externals or {},
        )
        exec_info = {}
        st(*arrays, **(scalars or {}), exec_info=exec_info, **call_kw)
        return exec_info["kernel"]

    shape = (20, 19, 4)
    assert run(
        defs.horizontal_diffusion,
        (rng.random(shape), np.zeros(shape), rng.random(shape)),
        origin=(2, 2, 0), domain=(16, 15, 4),
    ) == "xla"

    shape = (8, 9, 8)
    assert run(
        defs.tridiagonal_solver,
        (-np.ones(shape), np.full(shape, 4.0), -np.ones(shape),
         rng.random(shape), np.zeros(shape)),
    ) == "triton-interpret"

    shape = (6, 5, 9)
    assert run(
        defs.vertical_advection_dycore,
        tuple(rng.random(shape) for _ in range(5)),
        scalars={"dtr_stage": 0.15},
        externals=defs.VADV_EXTERNALS,
        domain=(5, 5, 9),
    ) == "triton-interpret"

    from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

    F = gtscript.Field[np.float64]

    def kavg(inp: F, out: F):
        with computation(PARALLEL), interval(...):
            out = (inp[0, 0, -1] + inp[0, 0, 1]) * 0.5

    shape = (8, 9, 6)
    assert run(
        kavg, (rng.random(shape), np.zeros(shape)),
        origin=(0, 0, 1), domain=(8, 9, 4),
    ) == "xla"


def test_native_layout_chain_and_lazy_decode():
    """Ping-pong calls through the public API, then ``chain`` over the
    same steps: ``gpu`` matches ``jax`` and the storages hold their
    public (I, J, K) arrays after every call."""
    from gt4py_tpu import storage

    F = gtscript.Field[np.float64]

    def smooth(inp: F, out: F):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            out = 0.5 * inp[0, 0, 0] + 0.125 * (
                inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
            )

    rng = np.random.default_rng(7)
    shape = (20, 22, 6)
    data = rng.random(shape)

    results = {}
    for backend in ("jax", "gpu"):
        st = gtscript.stencil(backend=backend, definition=smooth, name=f"sm_{backend}")
        a = storage.from_array(data, backend=backend)
        b = storage.zeros(shape, backend=backend)
        for _ in range(3):  # a->b, b->a, a->b
            st(a, b, origin=(1, 1, 0), domain=(18, 20, 6))
            st(b, a, origin=(1, 1, 0), domain=(18, 20, 6))
        assert a.array.shape == shape and b.array.shape == shape
        c = storage.from_array(data, backend=backend)
        d = storage.zeros(shape, backend=backend)
        st.chain(
            6, c, d, swap={"inp": "out", "out": "inp"},
            origin=(1, 1, 0), domain=(18, 20, 6),
        )
        results[backend] = (np.asarray(a), np.asarray(b), np.asarray(c))

    for got, want in zip(results["gpu"], results["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-13)
    np.testing.assert_allclose(results["gpu"][2], results["gpu"][0], rtol=1e-13)


def test_high_side_k_halo_stays_correct(rng):
    """A field carrying K rows ABOVE the domain must have them read (not
    clamp-shadowed) by the K-sweep kernel."""
    from gt4py_tpu.cartesian.gtscript import FORWARD, computation, interval

    F = gtscript.Field[np.float64]

    def s(inp: F, out: F):
        with computation(FORWARD), interval(...):
            out = inp[0, 0, 1]

    st = build(s, name="khalo_hi")
    ni, nj, nk = 4, 5, 6
    inp = rng.random((ni, nj, nk + 1))  # one high-side K halo row
    out = np.zeros((ni, nj, nk))
    exec_info = {}
    st(inp, out, domain=(ni, nj, nk), exec_info=exec_info)
    assert exec_info["kernel"] == "triton-interpret"
    np.testing.assert_allclose(out, inp[:, :, 1 : nk + 1])
