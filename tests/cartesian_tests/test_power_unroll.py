"""GTIR power unrolling (reference power_unrolling.py analog for the
cartesian pipeline): small integral exponents become multiplications —
the Pallas kernels then avoid the transcendental pow path."""

import numpy as np

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtir_pretty import pretty
from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

F = gtscript.Field[np.float64]


def test_small_int_powers_unroll():
    def powers(a: F, out: F):
        with computation(PARALLEL), interval(...):
            out = a**4 + a**2 + a**1 + a**0

    st = gtscript.stencil(backend="jax", definition=powers)
    text = pretty(st._analyzed.stencil)
    assert "**" not in text

    a = storage.from_array(np.linspace(0.5, 2.0, 24).reshape(4, 3, 2), backend="jax")
    out = storage.zeros((4, 3, 2), backend="jax")
    st(a=a, out=out)
    x = np.asarray(a)
    np.testing.assert_allclose(np.asarray(out), x**4 + x**2 + x + 1.0, rtol=1e-14)


def test_fractional_power_stays():
    def frac(a: F, out: F):
        with computation(PARALLEL), interval(...):
            out = a**1.5

    st = gtscript.stencil(backend="jax", definition=frac)
    text = pretty(st._analyzed.stencil)
    assert "**" in text or "pow" in text

    a = storage.from_array(np.linspace(0.5, 2.0, 24).reshape(4, 3, 2), backend="jax")
    out = storage.zeros((4, 3, 2), backend="jax")
    st(a=a, out=out)
    np.testing.assert_allclose(np.asarray(out), np.asarray(a) ** 1.5, rtol=1e-14)


def test_unrolled_power_on_pallas_interpret():
    def cube(a: F, out: F):
        with computation(PARALLEL), interval(...):
            out = (a + 1.0) ** 3

    st = gtscript.stencil(backend="gpu", definition=cube)
    a = storage.from_array(np.linspace(0.0, 1.0, 8 * 16 * 4).reshape(8, 16, 4),
                           backend="gpu")
    out = storage.zeros((8, 16, 4), backend="gpu")
    st(a=a, out=out)
    np.testing.assert_allclose(np.asarray(out), (np.asarray(a) + 1.0) ** 3, rtol=1e-6)
