"""The K-sweep kernel (cartesian/backend/ksweep_triton.py).

On the CPU test platform the kernel runs in the Pallas interpreter, so the
registry's sequential stencils are compared with the ``numpy`` backend in
float64 and float32 (the GTIR narrowed to 32 bits, oracle included). A
second set lowers the same kernels for CUDA, which runs the Pallas-Triton
lowering here: an operation the Triton route cannot express fails on the
CPU, not first on the card. Then the eligibility gate, the ``kernel`` tag
and the platform check.
"""

import numpy as np
import pytest

from gt4py_tpu.cartesian import frontend, gtir, gtscript
from gt4py_tpu.cartesian.backend import ksweep_triton
from gt4py_tpu.cartesian.backend.base import REGISTRY as BACKENDS
from gt4py_tpu.cartesian.backend.evaluator import Evaluator
from gt4py_tpu.cartesian.definitions import AccessKind
from gt4py_tpu.cartesian.gtscript import FORWARD, PARALLEL, computation, erf, interval
from gt4py_tpu.cartesian.passes.pipeline import analyze_gtir
from gt4py_tpu.testing.narrowing import narrow_stencil

from . import stencil_defs as defs
from .test_registry import _alloc_inputs

SEQUENTIAL = [
    "tridiagonal_solver",
    "vertical_advection_dycore",
    "forward_cumsum",
    "backward_cumsum",
    "multi_section_forward",
    "staggeredish_interval_chain",
    "iteration_index_sequential",
    "dycore_smagorinsky_like",
]
DTYPES = {"f64": np.float64, "f32": np.float32}


def _analyzed(name, precision):
    entry = defs.REGISTRY[name]
    bits = 64 if precision == "f64" else 32
    options = {
        "externals": dict(entry["externals"]),
        "dtypes": dict(entry["dtypes"]),
        "literal_float_precision": bits,
        "literal_int_precision": bits,
        "name": f"{name}_{precision}",
    }
    ir = frontend.parse_stencil(entry["definition"], options)
    if precision == "f32":
        ir = narrow_stencil(ir)
    return analyze_gtir(ir, options)


def _case(name, precision, domain):
    """(analyzed, arrays, scalars, origins) for a registry stencil."""
    analyzed = _analyzed(name, precision)

    class _Infos:  # the slice of StencilObject that _alloc_inputs reads
        field_info = analyzed.field_infos

    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = _alloc_inputs(_Infos, rng, domain)
    scalars = {
        k: np.asarray(v, dtype=analyzed.parameter_infos[k].dtype)[()]
        for k, v in defs.REGISTRY[name]["scalars"].items()
    }
    origins = {
        n: tuple(b if m else 0 for b, m in zip(fi.boundary.lower, fi.domain_mask))
        for n, fi in analyzed.field_infos.items()
        if fi.access != AccessKind.NONE and fi.axes
    }
    return analyzed, arrays, scalars, origins


@pytest.mark.parametrize("precision", sorted(DTYPES))
@pytest.mark.parametrize("name", SEQUENTIAL)
def test_registry_sequential_stencil_in_interpret_mode(name, precision):
    import jax.numpy as jnp

    domain = (9, 6, max(8, defs.REGISTRY[name]["min_k"]))
    analyzed, arrays, scalars, origins = _case(name, precision, domain)
    gpu = BACKENDS["gpu"](analyzed, {})
    oracle = BACKENDS["numpy"](analyzed, {})
    ref = oracle.run({k: v.copy() for k, v in arrays.items()}, dict(scalars), domain, origins)
    got = gpu.run({k: jnp.asarray(v) for k, v in arrays.items()}, dict(scalars), domain, origins)
    assert gpu.last_kernel == "triton-interpret"
    rtol = 1e-12 if precision == "f64" else 2e-5
    for fname, expected in ref.items():
        assert np.asarray(got[fname]).dtype == DTYPES[precision]
        np.testing.assert_allclose(
            np.asarray(got[fname]), expected, rtol=rtol, atol=rtol, err_msg=fname
        )


@pytest.mark.parametrize("precision", sorted(DTYPES))
@pytest.mark.parametrize("name", SEQUENTIAL)
def test_registry_sequential_stencil_lowers_for_cuda(name, precision):
    """The kernel as compiled for the card, up to Triton IR: a non-power-
    of-two domain, so the edge tiles are masked."""
    import jax

    domain = (37, 70, 12)
    analyzed, arrays, scalars, origins = _case(name, precision, domain)
    served = set()

    def step(arrays, scalars):
        ev = Evaluator(analyzed, domain, origins, arrays, scalars, ns="jax", ksweep="triton")
        out = ev.run()
        served.update(ev.kernels)
        return out

    lowered = jax.jit(step).trace(arrays, scalars).lower(lowering_platforms=("cuda",))
    assert served == {"triton"}
    assert "xla.gpu.triton" in lowered.as_text()


@pytest.mark.parametrize("func", list(gtir.NativeFunction), ids=lambda f: f.value)
def test_native_gate_matches_triton_lowering(func):
    """A native function passes the gate exactly when its ``jax.numpy`` form
    lowers on the Triton route."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    from gt4py_tpu.cartesian.backend.evaluator import _NamespaceOps, _native_impls

    impl = _native_impls(_NamespaceOps("jax"))[func]

    def kernel(x_ref, o_ref):
        x = plgpu.load(x_ref.at[pl.ds(0, 16)])
        plgpu.store(o_ref.at[pl.ds(0, 16)], impl(*[x] * func.arity).astype(o_ref.dtype))

    def f(x):
        out = jax.ShapeDtypeStruct((16,), jnp.float64)
        return pl.pallas_call(kernel, out_shape=out, backend="triton")(x)

    try:
        jax.jit(f).trace(jnp.ones(16)).lower(lowering_platforms=("cuda",))
        lowers = True
    except NotImplementedError:
        lowers = False
    assert lowers == (func in ksweep_triton._NATIVES)


def _plan(definition, domain=(4, 4, 6), section=-1, **build):
    st = gtscript.stencil(backend="numpy", definition=definition, rebuild=True, **build)
    analyzed = st._analyzed
    arrays = {}
    for n, fi in analyzed.field_infos.items():
        if fi.access == AccessKind.NONE:
            continue
        shape = tuple(
            lo + d + hi
            for lo, d, hi, m in zip(fi.boundary.lower, domain, fi.boundary.upper, fi.domain_mask)
            if m
        ) + tuple(fi.data_dims)
        arrays[n] = np.zeros(shape, fi.dtype)
    origins = {
        n: tuple(b if m else 0 for b, m in zip(fi.boundary.lower, fi.domain_mask))
        for n, fi in analyzed.field_infos.items()
        if n in arrays
    }
    ev = Evaluator(analyzed, domain, origins, arrays, {}, ns="jax")
    loop = [v for v in ev.stencil.vertical_loops if v.loop_order.name != "PARALLEL"][-1]
    sec = loop.sections[section]
    return ev, ev._plane_plan(sec, backward=loop.loop_order.name == "BACKWARD")


F = gtscript.Field[np.float64]
FIJ = gtscript.Field[gtscript.IJ, np.float64]
FV = gtscript.Field[(np.float64, (2,))]
FB = gtscript.Field[np.bool_]


def test_gate_accepts_tridiagonal():
    ev, plan = _plan(defs.tridiagonal_solver)
    assert ksweep_triton.unsupported(ev, plan) is None


def test_gate_refuses_horizontal_read_of_written_field():
    def shifted(a: F, out: F):
        with computation(FORWARD), interval(0, 1):
            out = a
        with computation(FORWARD), interval(1, None):
            out = out[0, 0, -1] + a
        with computation(PARALLEL), interval(...):
            a = out[1, 0, 0]

    ev, plan = _plan(shifted, domain=(4, 4, 6), section=-1)
    assert "horizontal" in ksweep_triton.unsupported(ev, plan)


def test_gate_refuses_ij_field_and_data_dims():
    def surface(a: F, s: FIJ, out: F):
        with computation(FORWARD), interval(0, 1):
            out = a + s
        with computation(FORWARD), interval(1, None):
            out = out[0, 0, -1] + s

    ev, plan = _plan(surface)
    assert "neither an IJK nor a K field" in ksweep_triton.unsupported(ev, plan)

    def vec(a: FV, out: F):
        with computation(FORWARD), interval(0, 1):
            out = a[0, 0, 0][0]
        with computation(FORWARD), interval(1, None):
            out = out[0, 0, -1] + a[0, 0, 0][1]

    ev, plan = _plan(vec)
    assert "data dimensions" in ksweep_triton.unsupported(ev, plan)


def test_gate_refuses_natives_without_triton_lowering_and_bool_fields():
    def with_erf(a: F, out: F):
        with computation(FORWARD), interval(0, 1):
            out = a
        with computation(FORWARD), interval(1, None):
            out = erf(out[0, 0, -1]) + a

    ev, plan = _plan(with_erf)
    assert "native function" in ksweep_triton.unsupported(ev, plan)

    def masked(a: F, m: FB, out: F):
        with computation(FORWARD), interval(0, 1):
            out = a
        with computation(FORWARD), interval(1, None):
            out = out[0, 0, -1] + a if m else a

    ev, plan = _plan(masked)
    assert "dtype bool" in ksweep_triton.unsupported(ev, plan)


def test_section_temporaries_stay_in_the_kernel():
    """A temporary read only inside its own section is not a kernel output;
    one read by a later loop is."""

    def two_temps(a: F, out: F):
        with computation(FORWARD), interval(0, 1):
            t = a
            u = a
        with computation(FORWARD), interval(1, None):
            t = t[0, 0, -1] + a
            u = 2.0 * t
        with computation(PARALLEL), interval(...):
            out = u

    ev, plan = _plan(two_temps, section=-1)
    assert plan.written == ["t", "u"]
    assert ksweep_triton._live_out(ev, plan) == ["u"]


def test_kernel_tag_per_backend(rng=np.random.default_rng(3)):
    """``exec_info["kernel"]``: ``xla`` on ``jax`` always; on ``gpu`` the
    kernel's mode when a section ran in it, through calls and chains."""
    shape = (5, 6, 7)
    inp = rng.random(shape)
    tags = {}
    for backend in ("jax", "gpu"):
        st = gtscript.stencil(backend=backend, definition=defs.forward_cumsum, rebuild=True)
        out = np.zeros(shape)
        info = {}
        st(inp, out, exec_info=info)
        np.testing.assert_allclose(out, np.cumsum(inp, axis=2), rtol=1e-12)
        chain_info = {}
        st.chain(2, inp, out, exec_info=chain_info)
        tags[backend] = (info["kernel"], chain_info["kernel"])
    assert tags == {"jax": ("xla", "xla"), "gpu": ("triton-interpret", "triton-interpret")}

    st = gtscript.stencil(backend="gpu", definition=defs.copy_stencil, rebuild=True)
    info = {}
    st(inp, np.zeros(shape), exec_info=info)
    assert info["kernel"] == "xla"


@pytest.mark.parametrize("platform,mode", [("cpu", "triton-interpret"), ("gpu", "triton")])
def test_kernel_mode_follows_platform(monkeypatch, platform, mode):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert ksweep_triton.kernel_mode() == mode


def test_other_platform_raises(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pytest.raises(RuntimeError, match="GPU, or on the CPU"):
        ksweep_triton.kernel_mode()
    with pytest.raises(RuntimeError, match="GPU, or on the CPU"):
        gtscript.stencil(backend="gpu", definition=defs.forward_cumsum, rebuild=True)(
            np.ones((2, 2, 4)), np.zeros((2, 2, 4))
        )


@pytest.mark.parametrize("n,cap,expected", [(1, 32, 1), (5, 32, 8), (32, 32, 32), (512, 32, 32), (3, 4, 4)])
def test_block_is_a_power_of_two_within_cap(n, cap, expected):
    assert ksweep_triton._block(n, cap) == expected

