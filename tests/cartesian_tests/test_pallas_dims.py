"""Lower-dimensional and data-dimension fields on the ``gpu`` backend.

Every test compares against the numpy backend and asserts which path
served the call (``exec_info["kernel"]``): PARALLEL work is XLA's, and the
K-sweep kernel takes only sequential sections over plain IJK fields, so
sections reading IJ, K or vector fields stay on the XLA scan.

Reference parity: lower-dim fields
/root/reference/src/gt4py/cartesian/gtscript.py (Field[IJ, ...]) and
data-dimension vector fields (gtscript_frontend.py:1506 matmul tests,
stencil_definitions.py data_dims stencils).
"""

import numpy as np
import pytest

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

F3 = gtscript.Field[np.float32]
F_IJ = gtscript.Field[gtscript.IJ, np.float32]
F_K = gtscript.Field[gtscript.K, np.float32]
F_IK = gtscript.Field[gtscript.IK, np.float32]
F_V3 = gtscript.Field[(np.float32, (3,))]
F_M22 = gtscript.Field[(np.float32, (2, 2))]
I3 = gtscript.Field[np.int32]

SHAPE = (10, 12, 6)
HALO = 1
DOMAIN = (8, 10, 6)


def _run(definition, arrays, backend, domain=DOMAIN, origin=(HALO, HALO, 0)):
    st = gtscript.stencil(
        backend=backend,
        definition=definition,
        literal_float_precision=32,
        literal_int_precision=32,
        name=f"{definition.__name__}_{backend.replace(':', '_')}",
    )
    stores = {n: storage.from_array(v, backend=backend) for n, v in arrays.items()}
    info: dict = {}
    st(**stores, origin=origin, domain=domain, exec_info=info)
    return {n: np.asarray(v) for n, v in stores.items()}, info


def _compare(definition, arrays, expect_kernel="xla"):
    ref, _ = _run(definition, arrays, "numpy")
    got, info = _run(definition, arrays, "gpu")
    assert info.get("kernel") == expect_kernel, info
    for n in arrays:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-6, atol=1e-6, err_msg=n)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def test_ij_field_read(rng):
    def st(a: F3, surf: F_IJ, out: F3):
        with computation(PARALLEL), interval(...):
            out = a[0, 0, 0] + surf[1, 0] - surf[-1, 1]

    _compare(
        st,
        {
            "a": rng.random(SHAPE, dtype=np.float32),
            "surf": rng.random(SHAPE[:2], dtype=np.float32),
            "out": np.zeros(SHAPE, np.float32),
        },
    )


def test_k_field_read(rng):
    def st(a: F3, prof: F_K, out: F3):
        with computation(PARALLEL), interval(...):
            out = a[0, 0, 0] * prof[0]

    _compare(
        st,
        {
            "a": rng.random(SHAPE, dtype=np.float32),
            "prof": rng.random((SHAPE[2],), dtype=np.float32),
            "out": np.zeros(SHAPE, np.float32),
        },
    )


def test_ik_field_read(rng):
    def st(a: F3, wall: F_IK, out: F3):
        with computation(PARALLEL), interval(...):
            out = a[0, 0, 0] + wall[1, 0]

    _compare(
        st,
        {
            "a": rng.random(SHAPE, dtype=np.float32),
            "wall": rng.random((SHAPE[0], SHAPE[2]), dtype=np.float32),
            "out": np.zeros(SHAPE, np.float32),
        },
    )


def test_vector_field_static_index(rng):
    def st(v: F_V3, out: F3):
        with computation(PARALLEL), interval(...):
            out = v[0, 0, 0][0] + 2.0 * v[1, 0, 0][1] - v[0, -1, 0][2]

    _compare(
        st,
        {
            "v": rng.random(SHAPE + (3,), dtype=np.float32),
            "out": np.zeros(SHAPE, np.float32),
        },
    )


def test_vector_field_write(rng):
    def st(a: F3, v: F_V3):
        with computation(PARALLEL), interval(...):
            v[0, 0, 0][0] = a[0, 0, 0] * 2.0
            v[0, 0, 0][2] = a[0, 0, 0] - 1.0

    _compare(
        st,
        {
            "a": rng.random(SHAPE, dtype=np.float32),
            "v": rng.random(SHAPE + (3,), dtype=np.float32),
        },
    )


def test_matrix_field_static_index(rng):
    def st(m: F_M22, out: F3):
        with computation(PARALLEL), interval(...):
            out = m[0, 0, 0][0, 1] + m[0, 0, 0][1, 0]

    _compare(
        st,
        {
            "m": rng.random(SHAPE + (2, 2), dtype=np.float32),
            "out": np.zeros(SHAPE, np.float32),
        },
    )


def test_vector_field_dynamic_index(rng):
    def st(v: F_V3, sel: I3, out: F3):
        with computation(PARALLEL), interval(...):
            out = v[0, 0, 0][sel[0, 0, 0]]

    _compare(
        st,
        {
            "v": rng.random(SHAPE + (3,), dtype=np.float32),
            "sel": rng.integers(0, 3, SHAPE).astype(np.int32),
            "out": np.zeros(SHAPE, np.float32),
        },
    )


def test_mixed_lower_dims_and_vector(rng):
    def st(a: F3, surf: F_IJ, prof: F_K, v: F_V3, out: F3):
        with computation(PARALLEL), interval(...):
            out = a[0, 0, 0] + surf[0, 1] * prof[0] + v[0, 0, 0][1]

    _compare(
        st,
        {
            "a": rng.random(SHAPE, dtype=np.float32),
            "surf": rng.random(SHAPE[:2], dtype=np.float32),
            "prof": rng.random((SHAPE[2],), dtype=np.float32),
            "v": rng.random(SHAPE + (3,), dtype=np.float32),
            "out": np.zeros(SHAPE, np.float32),
        },
    )


def test_lower_dim_write_falls_back(rng):
    """Writing a lower-dim field from a K-spanning loop runs on XLA; the
    public result must be correct."""

    def st(a: F3, surf: F_IJ):
        with computation(PARALLEL), interval(0, 1):
            surf = a[0, 0, 0]

    arrays = {
        "a": rng.random(SHAPE, dtype=np.float32),
        "surf": np.zeros(SHAPE[:2], np.float32),
    }
    ref, _ = _run(st, arrays, "numpy")
    got, info = _run(st, arrays, "gpu")
    assert info.get("kernel") == "xla"
    np.testing.assert_allclose(got["surf"], ref["surf"], rtol=1e-6)


FORWARD = "FORWARD"
BACKWARD = "BACKWARD"


def test_staged_sequential_with_surface_and_profile(rng):
    """FORWARD scan reading IJ + K + vector fields: the K-sweep kernel
    refuses the section (not plain IJK fields) and the XLA scan serves it."""

    def st(a: F3, surf: F_IJ, prof: F_K, v: F_V3, out: F3):
        with computation(FORWARD):
            with interval(0, 1):
                out = a[0, 0, 0] + surf[0, 0] * prof[0] + v[0, 0, 0][0]
            with interval(1, None):
                out = out[0, 0, -1] * 0.5 + a[0, 0, 0] + surf[1, -1] + v[0, 0, 0][2]

    arrays = {
        "a": rng.random(SHAPE, dtype=np.float32),
        "surf": rng.random(SHAPE[:2], dtype=np.float32),
        "prof": rng.random((SHAPE[2],), dtype=np.float32),
        "v": rng.random(SHAPE + (3,), dtype=np.float32),
        "out": np.zeros(SHAPE, np.float32),
    }
    ref, _ = _run(st, arrays, "numpy")
    got, info = _run(st, arrays, "gpu")
    assert info.get("kernel") == "xla", info
    for n in arrays:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-5, atol=1e-6, err_msg=n)


def test_staged_backward_with_dynamic_vector_index(rng):
    def st(v: F_V3, sel: I3, out: F3):
        with computation(BACKWARD):
            with interval(-1, None):
                out = v[0, 0, 0][sel[0, 0, 0]]
            with interval(0, -1):
                out = out[0, 0, 1] * 0.25 + v[0, 0, 0][sel[0, 0, 0]]

    arrays = {
        "v": rng.random(SHAPE + (3,), dtype=np.float32),
        "sel": rng.integers(0, 3, SHAPE).astype(np.int32),
        "out": np.zeros(SHAPE, np.float32),
    }
    ref, _ = _run(st, arrays, "numpy")
    got, info = _run(st, arrays, "gpu")
    assert info.get("kernel") == "xla", info
    for n in arrays:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-5, atol=1e-6, err_msg=n)


def test_pure_2d_stencil_served_natively(rng):
    """All-IJ stencils (nk == 1): a degenerate K axis runs like any
    PARALLEL stencil, on XLA."""
    Field2D = gtscript.Field[gtscript.IJ, np.float64]

    def lap2d(src: Field2D, dst: Field2D):
        with computation(PARALLEL), interval(...):
            dst = src[1, 0] + src[-1, 0] + src[0, 1] + src[0, -1] - 4.0 * src

    st = gtscript.stencil(backend="gpu", definition=lap2d)
    src = rng.random((10, 10))
    dst = np.zeros((10, 10))
    info = {}
    st(src, dst, origin=(1, 1), domain=(8, 8, 1), exec_info=info)
    assert info["kernel"] == "xla"
    expected = (
        src[2:, 1:-1] + src[:-2, 1:-1] + src[1:-1, 2:] + src[1:-1, :-2]
        - 4.0 * src[1:-1, 1:-1]
    )
    np.testing.assert_allclose(dst[1:9, 1:9], expected)
