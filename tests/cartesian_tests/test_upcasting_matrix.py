"""Dtype upcasting semantics across backends (reference
gtc/passes/gtir_upcaster.py + test_gtir_upcaster.py: mixed-dtype
expressions promote by NumPy rules identically in every backend)."""

import numpy as np
import pytest

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

from .definitions import ALL_BACKENDS

F64 = gtscript.Field[np.float64]
F32 = gtscript.Field[np.float32]
I32 = gtscript.Field[np.int32]
I64 = gtscript.Field[np.int64]


def _run(definition, backend, arrays, name):
    st = gtscript.stencil(backend=backend, definition=definition, name=f"{name}_{backend.replace(':', '_')}")
    stores = {
        k: storage.from_array(v, backend=backend) for k, v in arrays.items()
    }
    st(**stores)
    return {k: np.asarray(v) for k, v in stores.items()}


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_int_plus_float_promotes(backend):
    def s(i32: I32, f32: F32, out: F64):
        with computation(PARALLEL), interval(...):
            out = i32 + f32  # int32 + float32 -> promoted, then cast to f64

    rng = np.random.default_rng(0)
    arrays = {
        "i32": rng.integers(-5, 5, (4, 4, 2)).astype(np.int32),
        "f32": rng.random((4, 4, 2)).astype(np.float32),
        "out": np.zeros((4, 4, 2)),
    }
    got = _run(s, backend, arrays, "ipf")["out"]
    expected = (arrays["i32"] + arrays["f32"]).astype(np.float64)
    np.testing.assert_allclose(got, expected, rtol=1e-6)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_int_division_promotes_to_float(backend):
    def s(a: I64, b: I64, out: F64):
        with computation(PARALLEL), interval(...):
            out = a / b

    rng = np.random.default_rng(1)
    arrays = {
        "a": rng.integers(1, 20, (4, 4, 2)).astype(np.int64),
        "b": rng.integers(1, 9, (4, 4, 2)).astype(np.int64),
        "out": np.zeros((4, 4, 2)),
    }
    got = _run(s, backend, arrays, "idiv")["out"]
    np.testing.assert_allclose(got, arrays["a"] / arrays["b"], rtol=1e-12)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_literal_precision_does_not_widen_f32(backend):
    def s(f32: F32, out: F32):
        with computation(PARALLEL), interval(...):
            out = f32 * 2.0 + 1.0

    rng = np.random.default_rng(2)
    arrays = {
        "f32": rng.random((4, 4, 2)).astype(np.float32),
        "out": np.zeros((4, 4, 2), np.float32),
    }
    st32 = gtscript.stencil(
        backend=backend, definition=s, literal_float_precision=32,
        name=f"lit32_{backend.replace(':', '_')}",
    )
    stores = {k: storage.from_array(v, backend=backend) for k, v in arrays.items()}
    st32(**stores)
    got = np.asarray(stores["out"])
    assert got.dtype == np.float32
    np.testing.assert_allclose(
        got, arrays["f32"] * np.float32(2.0) + np.float32(1.0), rtol=1e-6
    )


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_comparison_yields_bool_then_selects(backend):
    def s(a: F64, b: F32, out: F64):
        with computation(PARALLEL), interval(...):
            out = a if a > b else b  # mixed compare + ternary promote

    rng = np.random.default_rng(3)
    arrays = {
        "a": rng.random((4, 4, 2)),
        "b": rng.random((4, 4, 2)).astype(np.float32),
        "out": np.zeros((4, 4, 2)),
    }
    got = _run(s, backend, arrays, "cmpsel")["out"]
    expected = np.where(
        arrays["a"] > arrays["b"], arrays["a"], arrays["b"].astype(np.float64)
    )
    np.testing.assert_allclose(got, expected, rtol=1e-6)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_int_temporary_keeps_int_arithmetic(backend):
    def s(a: I32, out: I64):
        with computation(PARALLEL), interval(...):
            t = a * 2
            out = t + 1

    arrays = {
        "a": np.arange(32, dtype=np.int32).reshape(4, 4, 2),
        "out": np.zeros((4, 4, 2), np.int64),
    }
    got = _run(s, backend, arrays, "itmp")["out"]
    np.testing.assert_array_equal(got, arrays["a"].astype(np.int64) * 2 + 1)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_scalar_param_promotes_with_field(backend):
    def s(a: F32, out: F64, w: float):
        with computation(PARALLEL), interval(...):
            out = a * w

    rng = np.random.default_rng(4)
    arrays = {
        "a": rng.random((4, 4, 2)).astype(np.float32),
        "out": np.zeros((4, 4, 2)),
    }
    st = gtscript.stencil(backend=backend, definition=s, name=f"sp_{backend.replace(':', '_')}")
    stores = {k: storage.from_array(v, backend=backend) for k, v in arrays.items()}
    st(w=1.5, **stores)
    got = np.asarray(stores["out"])
    np.testing.assert_allclose(got, arrays["a"] * 1.5, rtol=1e-6)


# --- half-precision floats (extension: bfloat16/float16) ---------------------
#
# The promotion model: bf16 × f32
# -> f32, bf16 × f16 -> f32, bf16 × int -> bf16 (JAX lattice where NumPy's
# has no entry), and numeric Python literals adapt ("weak typing") to a
# half-precision operand instead of widening the expression.

from gt4py_tpu.core.definitions import bfloat16  # noqa: E402

BF16 = gtscript.Field[bfloat16]
F16 = gtscript.Field[np.float16]


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_bf16_times_f32_promotes(backend):
    def s(a: BF16, b: F32, out: F32):
        with computation(PARALLEL), interval(...):
            out = a * b

    rng = np.random.default_rng(2)
    arrays = {
        "a": rng.random((4, 4, 2)).astype(bfloat16),
        "b": rng.random((4, 4, 2)).astype(np.float32),
        "out": np.zeros((4, 4, 2), np.float32),
    }
    got = _run(s, backend, arrays, "bf16f32")["out"]
    expected = arrays["a"].astype(np.float32) * arrays["b"]
    np.testing.assert_allclose(got, expected, rtol=1e-6)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_bf16_literal_stays_narrow(backend):
    """Float literals weaken to bfloat16 — the whole expression stays
    16-bit (checked structurally on the analyzed IR)."""

    def s(a: BF16, out: BF16):
        with computation(PARALLEL), interval(...):
            out = a * 2.0 + 0.5

    rng = np.random.default_rng(3)
    arrays = {
        "a": rng.random((4, 4, 2)).astype(bfloat16),
        "out": np.zeros((4, 4, 2), bfloat16),
    }
    got = _run(s, backend, arrays, "bf16lit")["out"]
    assert got.dtype == np.dtype(bfloat16)
    expected = arrays["a"].astype(np.float32) * 2.0 + 0.5
    np.testing.assert_allclose(got.astype(np.float32), expected, rtol=0.02, atol=0.02)

    from gt4py_tpu import eve
    from gt4py_tpu.cartesian.passes.pipeline import analyze

    an = analyze(s, {"backend": "numpy"})
    dts = {
        str(n.dtype)
        for _, _, stmt in an.stencil.walk_stmts()
        for n in eve.walk_values(stmt)
        if hasattr(n, "dtype") and n.dtype is not None
    }
    assert dts == {"bfloat16"}, dts


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_bf16_int_literal_weakens(backend):
    def s(a: BF16, out: BF16):
        with computation(PARALLEL), interval(...):
            out = a + 1

    rng = np.random.default_rng(4)
    arrays = {
        "a": rng.random((4, 4, 2)).astype(bfloat16),
        "out": np.zeros((4, 4, 2), bfloat16),
    }
    got = _run(s, backend, arrays, "bf16int")["out"]
    np.testing.assert_allclose(
        got.astype(np.float32), arrays["a"].astype(np.float32) + 1.0, rtol=0.01
    )


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_f16_roundtrip(backend):
    def s(x: F16, y: F16):
        with computation(PARALLEL), interval(...):
            y = 2.0 * x + y

    rng = np.random.default_rng(5)
    x = rng.random((4, 4, 2)).astype(np.float16)
    y = rng.random((4, 4, 2)).astype(np.float16)
    arrays = {"x": x, "y": y.copy()}
    got = _run(s, backend, arrays, "f16")["y"]
    assert got.dtype == np.float16
    np.testing.assert_allclose(
        got.astype(np.float32), 2.0 * x.astype(np.float32) + y.astype(np.float32),
        rtol=0.01, atol=0.01,
    )


from gt4py_tpu.cartesian.gtscript import FORWARD  # noqa: E402


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_bf16_sequential_carry(backend):
    """bf16 fields through a FORWARD carry chain (the XLA scan: the
    K-sweep kernel takes float32/float64 fields only)."""

    def cumsum(a: BF16, out: BF16):
        with computation(FORWARD):
            with interval(0, 1):
                out = a
            with interval(1, None):
                out = out[0, 0, -1] + a

    rng = np.random.default_rng(6)
    a = rng.random((4, 4, 6)).astype(bfloat16)
    arrays = {"a": a, "out": np.zeros((4, 4, 6), bfloat16)}
    got = _run(cumsum, backend, arrays, "bf16cum")["out"]
    oracle = np.cumsum(a.astype(np.float32), axis=2)
    np.testing.assert_allclose(got.astype(np.float32), oracle, rtol=0.05, atol=0.3)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_bf16_transcendentals(backend):
    def s(a: BF16, out: BF16):
        with computation(PARALLEL), interval(...):
            out = sqrt(a) + exp(a)  # noqa: F821

    from gt4py_tpu.cartesian.gtscript import exp, sqrt  # noqa: F401

    rng = np.random.default_rng(7)
    a = rng.random((4, 4, 2)).astype(bfloat16)
    arrays = {"a": a, "out": np.zeros((4, 4, 2), bfloat16)}
    got = _run(s, backend, arrays, "bf16trans")["out"]
    af = a.astype(np.float32)
    np.testing.assert_allclose(
        got.astype(np.float32), np.sqrt(af) + np.exp(af), rtol=0.05, atol=0.05
    )


def test_bf16_f16_mix_promotes_to_f32():
    """bf16 × f16 has no NumPy promotion — follows JAX's lattice to f32."""

    def s(a: BF16, b: F16, out: F32):
        with computation(PARALLEL), interval(...):
            out = a + b

    rng = np.random.default_rng(8)
    arrays = {
        "a": rng.random((4, 4, 2)).astype(bfloat16),
        "b": rng.random((4, 4, 2)).astype(np.float16),
        "out": np.zeros((4, 4, 2), np.float32),
    }
    got = _run(s, "jax", arrays, "bf16f16")["out"]
    expected = arrays["a"].astype(np.float32) + arrays["b"].astype(np.float32)
    np.testing.assert_allclose(got, expected, rtol=1e-3)


def test_half_comparison_keeps_f64_counterpart():
    """A bf16 < f64 comparison must widen only the bf16 side: 1.0 (bf16)
    < 1.0 + 1e-9 (f64) is True; narrowing the f64 to f32 would equal them."""

    def s(a: BF16, b: F64, out: F64):
        with computation(PARALLEL), interval(...):
            if a < b:
                out = 1.0
            else:
                out = 0.0

    for backend in ("numpy", "jax"):
        arrays = {
            "a": np.ones((2, 2, 1), bfloat16),
            "b": np.full((2, 2, 1), 1.0 + 1e-9),
            "out": np.zeros((2, 2, 1)),
        }
        got = _run(s, backend, arrays, "halfcmp")["out"]
        np.testing.assert_allclose(got, 1.0, err_msg=backend)
