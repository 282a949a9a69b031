"""Storage interface breadth (reference tests/storage_tests/
unit_tests/test_interface.py + test_utils.py: dtype matrix, dimension
annotations, masked-dim storages in stencils, copy semantics, ndarray
protocol)."""

import numpy as np
import pytest

from gt4py_tpu import storage
from gt4py_tpu.storage.storage import Storage

BACKENDS = ["debug", "numpy", "jax", "gpu"]
DTYPES = [np.float32, np.float64, np.int32, np.int64, np.bool_]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dtype_matrix_zeros(backend, dtype):
    s = storage.zeros((3, 4, 2), dtype, backend=backend)
    assert s.dtype == np.dtype(dtype)
    assert s.shape == (3, 4, 2)
    np.testing.assert_array_equal(s.asnumpy(), np.zeros((3, 4, 2), dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_full_respects_dtype(dtype):
    s = storage.full((2, 2, 2), 3, dtype, backend="jax")
    assert s.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(s.asnumpy(), np.full((2, 2, 2), 3, dtype))


def test_from_array_casts_when_dtype_given():
    data = np.arange(6, dtype=np.int32).reshape(2, 3)
    s = storage.from_array(data, np.float64, backend="jax")
    assert s.dtype == np.dtype(np.float64)
    np.testing.assert_array_equal(s.asnumpy(), data.astype(np.float64))


def test_from_array_preserves_dtype_by_default():
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    s = storage.from_array(data, backend="jax")
    assert s.dtype == np.dtype(np.float32)


def test_dimensions_annotation_exported():
    s = storage.zeros((4, 4), dimensions=("I", "J"), backend="jax")
    assert s.__gt_dims__ == ("I", "J")
    s3 = storage.zeros((4, 4, 4), backend="jax")
    assert s3.__gt_dims__ is None or len(s3.__gt_dims__) == 3


def test_dimensions_length_validated():
    with pytest.raises(ValueError, match="dimensions"):
        storage.zeros((4, 4), dimensions=("I", "J", "K"), backend="jax")


def test_default_aligned_index_is_zero_origin():
    s = storage.zeros((4, 4, 4), backend="jax")
    assert s.__gt_origin__ == (0, 0, 0)


def test_copy_is_independent():
    s = storage.from_array(np.arange(4.0), backend="jax")
    c = s.copy()
    assert isinstance(c, Storage)
    s[0] = 99.0
    assert c[0] == 0.0
    assert s[0] == 99.0


def test_array_protocol_and_astype():
    s = storage.from_array(np.arange(4.0), backend="jax")
    as32 = np.asarray(s, dtype=np.float32)
    assert as32.dtype == np.dtype(np.float32)
    np.testing.assert_array_equal(np.array(s), np.arange(4.0))
    assert len(s) == 4
    assert s.size == 4 and s.ndim == 1


def test_setitem_slices():
    s = storage.zeros((4, 4), backend="jax")
    s[1:3, 1:3] = 2.5
    expected = np.zeros((4, 4))
    expected[1:3, 1:3] = 2.5
    np.testing.assert_array_equal(s.asnumpy(), expected)


def test_equality_is_elementwise():
    a = storage.from_array(np.arange(3.0), backend="jax")
    b = storage.from_array(np.arange(3.0), backend="jax")
    assert np.all(np.asarray(a == b))


# --- storages inside stencils ------------------------------------------------


def _lap2d_defn():
    from gt4py_tpu.cartesian import gtscript

    Field3D = gtscript.Field[np.float64]
    FieldIJ = gtscript.Field[gtscript.IJ, np.float64]

    def s(src: Field3D, weight: FieldIJ, dst: Field3D):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            dst = weight * (
                src[1, 0, 0] + src[-1, 0, 0] + src[0, 1, 0] + src[0, -1, 0]
            )

    return s


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_masked_dim_storage_in_stencil(backend):
    from gt4py_tpu.cartesian import gtscript

    st = gtscript.stencil(backend=backend, definition=_lap2d_defn())
    n = 8
    rng = np.random.default_rng(3)
    src_np = rng.random((n, n, 2))
    w_np = rng.random((n, n))
    src = storage.from_array(src_np, backend=backend, aligned_index=(1, 1, 0))
    w = storage.from_array(w_np, backend=backend, aligned_index=(1, 1))
    dst = storage.zeros((n, n, 2), backend=backend, aligned_index=(1, 1, 0))
    st(src, w, dst, domain=(n - 2, n - 2, 2))
    expected = w_np[1:-1, 1:-1, None] * (
        src_np[2:, 1:-1] + src_np[:-2, 1:-1] + src_np[1:-1, 2:] + src_np[1:-1, :-2]
    )
    np.testing.assert_allclose(dst.asnumpy()[1:-1, 1:-1], expected)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stencil_respects_storage_dtype(dtype):
    from gt4py_tpu.cartesian import gtscript

    Field = gtscript.Field[dtype]

    def s(a: Field, b: Field):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            b = a + a

    st = gtscript.stencil(backend="jax", definition=s, name=f"dbl_{np.dtype(dtype).name}")
    a = storage.ones((3, 3, 3), dtype, backend="jax")
    b = storage.zeros((3, 3, 3), dtype, backend="jax")
    st(a, b)
    assert b.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(b.asnumpy(), 2 * np.ones((3, 3, 3), dtype))


def test_numpy_ndarray_accepted_by_stencils():
    """Reference stencils accept raw ndarrays (storage_objects optional)."""
    from gt4py_tpu.cartesian import gtscript
    from tests.cartesian_tests import stencil_defs as defs

    st = gtscript.stencil(backend="jax", definition=defs.copy_stencil)
    a = np.arange(27.0).reshape(3, 3, 3)
    b = np.zeros((3, 3, 3))
    st(a, b)
    np.testing.assert_array_equal(b, a)
