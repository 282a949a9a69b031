"""Frozen-stencil and multi-value-function behavior matrices × backends.

Deepens two call-interface areas the reference covers broadly
(/root/reference/tests/cartesian_tests/integration_tests/feature_tests/
test_call_interface.py and unit_tests/frontend_tests/test_gtscript_frontend.py
multi-value returns): every registered CPU backend runs the same behavior
checks, so frozen-path shortcuts and the function inliner cannot drift
per backend.
"""

import numpy as np
import pytest

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import PARALLEL, FORWARD, computation, interval

from . import stencil_defs as defs
from .definitions import CPU_BACKENDS as _REGISTERED_CPU

ALL_BACKENDS = list(_REGISTERED_CPU)
FAST_BACKENDS = [b for b in ALL_BACKENDS if b != "debug"]

Field3D = gtscript.Field[np.float64]


def build(definition, backend, **kwargs):
    return gtscript.stencil(backend=backend, definition=definition, rebuild=True, **kwargs)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def copy_shift(src: Field3D, dst: Field3D):
    with computation(PARALLEL), interval(...):
        dst = src[1, 0, 0]


# --- frozen-stencil behavior matrix ------------------------------------------


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_sequential_stencil_matches_normal_call(backend, rng):
    """freeze() on a FORWARD scan (carry dependence) must match the
    validated call exactly — geometry pre-resolution cannot change the
    K-walk (reference stencil_object.py:95)."""
    st = build(defs.tridiagonal_solver, backend)
    shape = (4, 5, 8)
    inf = np.full(shape, -1.0)
    diag = np.full(shape, 4.0)
    sup = np.full(shape, -1.0)
    rhs = rng.random(shape)

    out_normal = np.zeros(shape)
    st(inf.copy(), diag.copy(), sup.copy(), rhs.copy(), out_normal,
       origin=(0, 0, 0), domain=shape)

    frozen = st.freeze(origin=(0, 0, 0), domain=shape)
    out_frozen = np.zeros(shape)
    frozen(inf=inf.copy(), diag=diag.copy(), sup=sup.copy(),
           rhs=rhs.copy(), out=out_frozen)
    np.testing.assert_allclose(out_frozen, out_normal, rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_repeated_calls_see_mutations(backend, rng):
    """A frozen stencil is a hot-loop entry point: calling it N times must
    iterate the operator (each call reads the previous call's writes), not
    replay a captured first input."""
    st = build(copy_shift, backend)
    shape = (9, 8, 3)
    src = rng.random(shape)
    dst = np.zeros(shape)
    frozen = st.freeze(origin=(1, 0, 0), domain=(7, 8, 3))

    a, b = src.copy(), dst
    ea, eb = src.copy(), dst.copy()
    for _ in range(3):
        frozen(src=a, dst=b)
        a, b = b, a
        eb[1:8] = ea[2:9]  # oracle: dst[i] = src[i+1] over the domain
        ea, eb = eb, ea
    np.testing.assert_allclose(a, ea, rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_accepts_storages_and_ndarrays(backend, rng):
    """The frozen path takes the same duck-typed field arguments as the
    normal path: Storage and plain ndarray must agree."""
    st = build(defs.scalar_inputs, backend)
    a = rng.random((5, 4, 3))
    frozen = st.freeze(origin=(0, 0, 0), domain=(5, 4, 3))

    buf_np = a.copy()
    frozen(field_a=buf_np, scalar_in=2.0)

    buf_st = storage.from_array(a, backend=backend)
    frozen(field_a=buf_st, scalar_in=2.0)
    np.testing.assert_allclose(np.asarray(buf_st), buf_np, rtol=1e-12)
    np.testing.assert_allclose(buf_np, a * 2.0, rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_missing_field_raises_keyerror(backend):
    st = build(defs.scalar_inputs, backend)
    frozen = st.freeze(origin=(0, 0, 0), domain=(4, 4, 2))
    with pytest.raises(KeyError):
        frozen(scalar_in=1.0)  # field_a missing


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_scalar_coercion_matches_normal(backend, rng):
    """Python ints passed for float scalar parameters coerce through the
    declared parameter dtype on the frozen path (the validated path
    rejects the mismatch by design — reference stencil_object type check)."""
    st = build(defs.scalar_inputs, backend)
    a = rng.random((4, 4, 2))
    normal = a.copy()
    st(normal, 3.0, origin=(0, 0, 0), domain=(4, 4, 2))
    with pytest.raises(TypeError):
        st(a.copy(), 3, origin=(0, 0, 0), domain=(4, 4, 2))

    frozen = st.freeze(origin=(0, 0, 0), domain=(4, 4, 2))
    buf = a.copy()
    frozen(field_a=buf, scalar_in=3)  # int for a float parameter
    np.testing.assert_allclose(buf, normal, rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_freeze_interleaves_with_normal_calls(backend, rng):
    """freeze() must not perturb the stencil object: normal-path calls
    before and after frozen calls all produce identical results (the two
    paths share backend caches keyed by geometry)."""
    st = build(defs.horizontal_diffusion, backend)
    shape = (12, 12, 3)
    in_field = rng.random(shape)
    coeff = rng.random(shape)

    out1 = np.zeros(shape)
    st(in_field.copy(), out1, coeff.copy(), origin=(2, 2, 0), domain=(8, 8, 3))

    frozen = st.freeze(origin=(2, 2, 0), domain=(8, 8, 3))
    out2 = np.zeros(shape)
    frozen(in_field=in_field.copy(), out_field=out2, coeff=coeff.copy())

    out3 = np.zeros(shape)
    st(in_field.copy(), out3, coeff.copy(), origin=(2, 2, 0), domain=(8, 8, 3))

    np.testing.assert_allclose(out2, out1, rtol=1e-12)
    np.testing.assert_allclose(out3, out1, rtol=1e-12)


@pytest.mark.parametrize("backend", FAST_BACKENDS)
def test_frozen_per_field_origin_mapping(backend, rng):
    """Per-field origins freeze into full (i,j,k) tuples once; a shifted
    input origin reads a different window than the output's."""
    st = build(defs.copy_stencil, backend)
    src = rng.random((8, 8, 2))
    dst = np.zeros((8, 8, 2))
    frozen = st.freeze(
        origin={"field_a": (2, 1, 0), "field_b": (0, 0, 0)}, domain=(5, 5, 2)
    )
    frozen(field_a=src, field_b=dst)
    np.testing.assert_allclose(dst[0:5, 0:5], src[2:7, 1:6], rtol=1e-12)


# --- multi-value gtscript.function matrix -------------------------------------


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_function_tuple_return_matrix(backend, rng):
    """Tuple-returning gtscript.function under every backend (reference
    gtscript_frontend multi-value returns; the round-3 test covered numpy
    only)."""

    @gtscript.function
    def split_pm(x):
        return x + 1.0, x - 1.0

    def st(a: Field3D, p: Field3D, m: Field3D):
        with computation(PARALLEL), interval(...):
            p, m = split_pm(a)

    s = build(st, backend)
    a = rng.random((4, 3, 2))
    p = np.zeros_like(a)
    m = np.zeros_like(a)
    s(a.copy(), p, m, origin=(0, 0, 0), domain=(4, 3, 2))
    np.testing.assert_allclose(p, a + 1.0, rtol=1e-12)
    np.testing.assert_allclose(m, a - 1.0, rtol=1e-12)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_function_tuple_chained_through_functions(backend, rng):
    """A tuple produced by one function, consumed element-wise by another,
    inside a sequential computation — inliner × scan interaction."""

    @gtscript.function
    def minmax(x, y):
        lo = x if x < y else y
        hi = x if x > y else y
        return lo, hi

    @gtscript.function
    def spread(lo, hi):
        return hi - lo

    def st(a: Field3D, b: Field3D, out: Field3D):
        with computation(FORWARD), interval(0, 1):
            lo, hi = minmax(a, b)
            out = spread(lo, hi)
        with computation(FORWARD), interval(1, None):
            lo, hi = minmax(a, b)
            out = out[0, 0, -1] + spread(lo, hi)

    s = build(st, backend)
    a = rng.random((3, 4, 5))
    b = rng.random((3, 4, 5))
    out = np.zeros_like(a)
    s(a.copy(), b.copy(), out, origin=(0, 0, 0), domain=(3, 4, 5))
    np.testing.assert_allclose(out, np.cumsum(np.abs(a - b), axis=2), rtol=1e-12)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_function_tuple_with_offsets_at_call_site(backend, rng):
    """Tuple results assigned to temporaries are fields: reading them at an
    offset after the unpacking must see neighboring columns' values."""

    @gtscript.function
    def pair(x):
        return 2.0 * x, x * x

    def st(a: Field3D, out: Field3D):
        with computation(PARALLEL), interval(...):
            d, q = pair(a)
            out = d[1, 0, 0] + q[-1, 0, 0]

    s = build(st, backend)
    a = rng.random((6, 3, 2))
    out = np.zeros_like(a)
    s(a.copy(), out, origin=(1, 0, 0), domain=(4, 3, 2))
    expected = 2.0 * a[2:6] + a[0:4] ** 2
    np.testing.assert_allclose(out[1:5], expected, rtol=1e-12)
