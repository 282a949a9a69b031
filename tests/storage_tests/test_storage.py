"""Storage layer tests (reference: tests/storage_tests/)."""

import numpy as np
import pytest

from gt4py_tpu import storage


def test_zeros_ones_full_empty():
    z = storage.zeros((3, 4, 5), backend="jax")
    assert z.shape == (3, 4, 5) and z.dtype == np.float64
    np.testing.assert_array_equal(np.asarray(z), 0.0)

    o = storage.ones((2, 2, 2), np.float32, backend="gpu")
    assert o.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(o), 1.0)

    f = storage.full((2, 2), 7.5, backend="numpy")
    np.testing.assert_array_equal(np.asarray(f), 7.5)

    e = storage.empty((2, 3), backend="debug")
    assert e.shape == (2, 3)


def test_from_array_and_roundtrip():
    data = np.arange(24.0).reshape(2, 3, 4)
    s = storage.from_array(data, backend="jax", aligned_index=(1, 1, 0))
    np.testing.assert_array_equal(s.asnumpy(), data)
    assert s.__gt_origin__ == (1, 1, 0)


def test_aligned_index_validation():
    with pytest.raises(ValueError):
        storage.zeros((3, 3), backend="jax", aligned_index=(1, 2, 3))
    with pytest.raises(ValueError):
        storage.zeros((3, 3), backend="jax", aligned_index=(-1, 0))
    with pytest.raises(ValueError):
        storage.zeros((3, 3), backend="not-a-backend")


def test_setitem_getitem():
    s = storage.zeros((4, 4), backend="jax")
    s[1, 2] = 5.0
    assert s[1, 2] == 5.0
    np.asarray(s)[0, 0] == 0.0


def test_default_origin_used_by_stencil():
    from gt4py_tpu.cartesian import gtscript
    from tests.cartesian_tests import stencil_defs as defs

    st = gtscript.stencil(backend="jax", definition=defs.horizontal_diffusion)
    n = 12
    rng = np.random.default_rng(0)
    in_f = storage.from_array(rng.random((n, n, 3)), backend="jax", aligned_index=(2, 2, 0))
    coeff = storage.from_array(rng.random((n, n, 3)), backend="jax", aligned_index=(2, 2, 0))
    out = storage.zeros((n, n, 3), backend="jax", aligned_index=(2, 2, 0))
    # No origin/domain passed: origin from aligned_index, max domain derived.
    st(in_f, out, coeff)
    expected = defs.validate_horizontal_diffusion(in_f.asnumpy(), coeff.asnumpy())
    np.testing.assert_allclose(out.asnumpy()[2:-2, 2:-2], expected)
