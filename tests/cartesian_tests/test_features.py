"""DSL feature tests: the GTScript language checklist from the reference
(/root/reference/src/gt4py/cartesian/gtscript.py and
docs/user/cartesian/lang_design.rst) exercised feature by feature."""

import numpy as np
import pytest

from gt4py_tpu import storage

from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.frontend import GTScriptDefinitionError, GTScriptSyntaxError
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    I,
    J,
    K,
    PARALLEL,
    computation,
    horizontal,
    interval,
    region,
)

Field3D = gtscript.Field[np.float64]
FieldK = gtscript.Field[gtscript.K, np.float64]
FieldIJ = gtscript.Field[gtscript.IJ, np.float64]

BACKENDS = ["numpy", "jax"]


def build(definition, backend, **kwargs):
    return gtscript.stencil(backend=backend, definition=definition, rebuild=True, **kwargs)


# --- externals / __INLINED / compile_assert ---------------------------------


def ext_stencil(a: Field3D):
    from __externals__ import FACTOR

    with computation(PARALLEL), interval(...):
        a = a * FACTOR


@pytest.mark.parametrize("backend", BACKENDS)
def test_externals(backend):
    st = build(ext_stencil, backend, externals={"FACTOR": 3.0})
    a = np.ones((3, 3, 3))
    st(a)
    np.testing.assert_allclose(a, 3.0)


def test_missing_external():
    with pytest.raises(GTScriptSyntaxError):
        build(ext_stencil, "numpy")


def inlined_if_stencil(a: Field3D):
    from __externals__ import FLAG

    with computation(PARALLEL), interval(...):
        if __INLINED(FLAG):  # noqa: F821
            a = a + 1.0
        else:
            a = a - 1.0


from gt4py_tpu.cartesian.gtscript import __INLINED  # noqa: E402,F401


@pytest.mark.parametrize("flag,delta", [(True, 1.0), (False, -1.0)])
def test_inlined_compile_time_if(flag, delta):
    st = build(inlined_if_stencil, "numpy", externals={"FLAG": flag})
    a = np.zeros((2, 2, 2))
    st(a)
    np.testing.assert_allclose(a, delta)
    # The pruned branch leaves no runtime conditionals behind:
    assert not any(
        s.mask is not None
        for _, _, s in st._analyzed.stencil.walk_stmts()
    )


def assert_stencil(a: Field3D):
    from __externals__ import N

    with computation(PARALLEL), interval(...):
        compile_assert(N > 0)  # noqa: F821
        a = a + N


from gt4py_tpu.cartesian.gtscript import compile_assert  # noqa: E402,F401


def test_compile_assert():
    st = build(assert_stencil, "numpy", externals={"N": 2})
    a = np.zeros((2, 2, 2))
    st(a)
    np.testing.assert_allclose(a, 2.0)
    with pytest.raises(GTScriptDefinitionError):
        build(assert_stencil, "numpy", externals={"N": 0})


# --- horizontal regions ------------------------------------------------------


def region_stencil(a: Field3D):
    with computation(PARALLEL), interval(...):
        with horizontal(region[I[0], :]):
            a = 10.0
        with horizontal(region[I[-1], J[0]:J[2]]):
            a = 20.0


@pytest.mark.parametrize("backend", BACKENDS + ["debug"])
def test_horizontal_region(backend):
    st = build(region_stencil, backend)
    a = np.zeros((4, 5, 2))
    st(a)
    expected = np.zeros((4, 5, 2))
    expected[0, :, :] = 10.0
    expected[-1, 0:2, :] = 20.0
    np.testing.assert_allclose(a, expected)


def region_multi(a: Field3D):
    with computation(PARALLEL), interval(...):
        with horizontal(region[I[0], :], region[I[-1], :]):
            a = 7.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_horizontal_region_multiple(backend):
    st = build(region_multi, backend)
    a = np.zeros((4, 3, 2))
    st(a)
    expected = np.zeros((4, 3, 2))
    expected[0] = expected[-1] = 7.0
    np.testing.assert_allclose(a, expected)


# --- axis-subset fields ------------------------------------------------------


def k_field_stencil(a: Field3D, prof: FieldK):
    with computation(PARALLEL), interval(...):
        a = a + prof[0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_k_only_field(backend):
    st = build(k_field_stencil, backend)
    a = np.zeros((3, 3, 5))
    prof = np.arange(5.0)
    st(a, prof)
    np.testing.assert_allclose(a, np.broadcast_to(prof, (3, 3, 5)))


def ij_read_stencil(a: Field3D, m2d: FieldIJ):
    with computation(PARALLEL), interval(...):
        a = a + m2d[1, 0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_ij_field_with_offset(backend):
    st = build(ij_read_stencil, backend)
    a = np.zeros((3, 3, 2))
    m2d = np.arange(16.0).reshape(4, 4)
    st(a, m2d, domain=(3, 3, 2))
    expected = np.broadcast_to(m2d[1:4, 0:3, None], (3, 3, 2))
    np.testing.assert_allclose(a, expected)


# --- data dimensions / GlobalTable ------------------------------------------

FieldVec = gtscript.Field[(np.float64, (3,))]


def data_dims_stencil(vec: FieldVec, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = vec[0, 0, 0][0] + vec[0, 0, 0][1] * 2.0 + vec[0, 0, 0][2] * 3.0


@pytest.mark.parametrize("backend", BACKENDS + ["debug"])
def test_data_dimensions(backend):
    st = build(data_dims_stencil, backend)
    rng = np.random.default_rng(0)
    vec = rng.random((3, 3, 2, 3))
    out = np.zeros((3, 3, 2))
    st(vec, out)
    np.testing.assert_allclose(out, vec[..., 0] + 2 * vec[..., 1] + 3 * vec[..., 2])


def data_dims_write(vec: FieldVec, src: Field3D):
    with computation(PARALLEL), interval(...):
        vec[0, 0, 0][1] = src * 2.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_data_dimension_write(backend):
    st = build(data_dims_write, backend)
    rng = np.random.default_rng(0)
    vec = np.zeros((3, 3, 2, 3))
    src = rng.random((3, 3, 2))
    st(vec, src)
    np.testing.assert_allclose(vec[..., 1], src * 2.0)
    np.testing.assert_allclose(vec[..., 0], 0.0)


Table = gtscript.GlobalTable[(np.float64, (4,))]


def table_lookup_plain(idx_field: gtscript.Field[np.int64], out: Field3D, table: Table):
    with computation(PARALLEL), interval(...):
        out = table[idx_field]


@pytest.mark.parametrize("backend", BACKENDS)
def test_global_table(backend):
    st = build(table_lookup_plain, backend)
    table = np.array([10.0, 20.0, 30.0, 40.0])
    idx = np.random.default_rng(0).integers(0, 4, (3, 3, 2))
    out = np.zeros((3, 3, 2))
    st(idx, out, table)
    np.testing.assert_allclose(out, table[idx])


# --- variable & absolute K offsets ------------------------------------------


def var_k_stencil(a: Field3D, idx: gtscript.Field[np.int64], out: Field3D):
    with computation(PARALLEL), interval(...):
        out = a[0, 0, idx]


@pytest.mark.parametrize("backend", BACKENDS + ["debug"])
def test_variable_k_offset(backend):
    st = build(var_k_stencil, backend)
    rng = np.random.default_rng(1)
    a = rng.random((3, 3, 6))
    idx = rng.integers(-2, 3, (3, 3, 6))
    out = np.zeros((3, 3, 6))
    st(a, idx, out)
    kk = np.clip(np.arange(6)[None, None, :] + idx, 0, 5)
    expected = np.take_along_axis(a, kk, axis=2)
    np.testing.assert_allclose(out, expected)


def abs_k_stencil(a: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = a.at(K=0) + a.at(K=1)


@pytest.mark.parametrize("backend", BACKENDS + ["debug"])
def test_absolute_k_index(backend):
    st = build(abs_k_stencil, backend)
    rng = np.random.default_rng(1)
    a = rng.random((3, 3, 4))
    out = np.zeros((3, 3, 4))
    st(a, out)
    expected = np.broadcast_to((a[:, :, 0] + a[:, :, 1])[:, :, None], (3, 3, 4))
    np.testing.assert_allclose(out, expected)


# --- dtypes option / literal precision ---------------------------------------


def generic_dtype_stencil(a: "gtscript.Field['dt']", b: "gtscript.Field['dt']"):  # noqa: F821
    with computation(PARALLEL), interval(...):
        b = a + 1


def test_dtypes_option():
    st = build(generic_dtype_stencil, "numpy", dtypes={"dt": np.float32})
    a = np.ones((2, 2, 2), dtype=np.float32)
    b = np.zeros((2, 2, 2), dtype=np.float32)
    st(a, b)
    np.testing.assert_allclose(b, 2.0)
    assert st.field_info["a"].dtype == np.float32


def int_fields(a: gtscript.Field[np.int32], b: gtscript.Field[np.int32]):
    with computation(PARALLEL), interval(...):
        b = a + 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_int_field_arithmetic(backend):
    st = build(int_fields, backend)
    a = np.full((2, 2, 2), 41, dtype=np.int32)
    b = np.zeros((2, 2, 2), dtype=np.int32)
    st(a, b)
    assert b.dtype == np.int32
    np.testing.assert_array_equal(b, 42)


# --- ternary / min-max folding / scalar if -----------------------------------


def ternary_stencil(a: Field3D, b: Field3D, *, t: float):
    with computation(PARALLEL), interval(...):
        b = a if a > t else -a


@pytest.mark.parametrize("backend", BACKENDS)
def test_ternary_and_scalar_param(backend):
    st = build(ternary_stencil, backend)
    a = np.random.default_rng(0).random((3, 3, 3)) - 0.5
    b = np.zeros_like(a)
    st(a, b, t=0.0)
    np.testing.assert_allclose(b, np.where(a > 0.0, a, -a))


def scalar_if_stencil(a: Field3D, *, flag: float):
    with computation(PARALLEL), interval(...):
        if flag > 0.0:
            a = a + 1.0
        else:
            a = a - 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_runtime_scalar_if(backend):
    st = build(scalar_if_stencil, backend)
    a = np.zeros((2, 2, 2))
    st(a, flag=1.0)
    np.testing.assert_allclose(a, 1.0)
    st(a, flag=-1.0)
    np.testing.assert_allclose(a, 0.0)


# --- error cases -------------------------------------------------------------


def test_write_to_scalar_rejected():
    def bad(a: Field3D, *, s: float):
        with computation(PARALLEL), interval(...):
            s = 3.0  # noqa: F841

    with pytest.raises(GTScriptSyntaxError):
        build(bad, "numpy")


def test_offset_write_rejected():
    def bad(a: Field3D):
        with computation(PARALLEL), interval(...):
            a[1, 0, 0] = 3.0

    with pytest.raises(GTScriptSyntaxError):
        build(bad, "numpy")


def test_overlapping_intervals_rejected():
    def bad(a: Field3D):
        with computation(FORWARD):
            with interval(0, 2):
                a = 1.0
            with interval(1, 3):
                a = 2.0

    with pytest.raises(GTScriptSyntaxError):
        build(bad, "numpy")


def test_missing_annotation_rejected():
    def bad(a):
        with computation(PARALLEL), interval(...):
            a = 1.0

    with pytest.raises(GTScriptDefinitionError):
        build(bad, "numpy")


# --- matmul / vector assignment / per-gridpoint data indices ------------------

FieldMat = gtscript.Field[(np.float64, (3, 3))]


def matmul_stencil(mat: FieldMat, vec: FieldVec, out: FieldVec):
    with computation(PARALLEL), interval(...):
        out = mat @ vec


@pytest.mark.parametrize("backend", BACKENDS)
def test_matmul_data_dims(backend):
    """'@' on data-dimension fields (reference gtscript_frontend.py:1506)
    with a whole-vector assignment (reference defir_to_gtir.py:123)."""
    st = build(matmul_stencil, backend)
    rng = np.random.default_rng(2)
    mat = rng.random((3, 3, 2, 3, 3))
    vec = rng.random((3, 3, 2, 3))
    out = np.zeros((3, 3, 2, 3))
    st(mat, vec, out)
    np.testing.assert_allclose(out, np.einsum("...mn,...n->...m", mat, vec))


def vector_scale(vec: FieldVec, out: FieldVec, factor: float):
    with computation(PARALLEL), interval(...):
        out = vec * factor


@pytest.mark.parametrize("backend", BACKENDS)
def test_vector_assignment(backend):
    st = build(vector_scale, backend)
    rng = np.random.default_rng(3)
    vec = rng.random((4, 3, 2, 3))
    out = np.zeros((4, 3, 2, 3))
    st(vec, out, factor=2.5)
    np.testing.assert_allclose(out, vec * 2.5)


def dynamic_component_read(vec: FieldVec, sel: gtscript.Field[np.int64], out: Field3D):
    with computation(PARALLEL), interval(...):
        out = vec[0, 0, 0][sel]


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_gridpoint_data_index_read(backend):
    st = build(dynamic_component_read, backend)
    rng = np.random.default_rng(4)
    vec = rng.random((4, 3, 2, 3))
    sel = rng.integers(0, 3, (4, 3, 2))
    out = np.zeros((4, 3, 2))
    st(vec, sel, out)
    np.testing.assert_allclose(out, np.take_along_axis(vec, sel[..., None], 3)[..., 0])


def dynamic_component_write(vec: FieldVec, sel: gtscript.Field[np.int64], src: Field3D):
    with computation(PARALLEL), interval(...):
        vec[0, 0, 0][sel] = src


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_gridpoint_data_index_write(backend):
    st = build(dynamic_component_write, backend)
    rng = np.random.default_rng(5)
    vec = np.zeros((4, 3, 2, 3))
    sel = rng.integers(0, 3, (4, 3, 2))
    src = rng.random((4, 3, 2))
    st(vec, sel, src)
    expected = np.zeros_like(vec)
    np.put_along_axis(expected, sel[..., None], src[..., None], axis=3)
    np.testing.assert_allclose(vec, expected)


def var_k_vector(vec: FieldVec, idx: gtscript.Field[np.int64], out: FieldVec):
    with computation(PARALLEL), interval(...):
        out = vec[0, 0, idx]


@pytest.mark.parametrize("backend", BACKENDS)
def test_variable_k_on_data_dims(backend):
    st = build(var_k_vector, backend)
    rng = np.random.default_rng(6)
    vec = rng.random((3, 3, 6, 3))
    idx = rng.integers(-2, 3, (3, 3, 6))
    out = np.zeros((3, 3, 6, 3))
    st(vec, idx, out)
    kk = np.clip(np.arange(6)[None, None, :] + idx, 0, 5)
    np.testing.assert_allclose(
        out, np.take_along_axis(vec, kk[..., None], axis=2)
    )


def nested_while(a: Field3D, b: Field3D):
    with computation(PARALLEL), interval(...):
        while a < 8.0:
            while b < 4.0:
                b = b + 1.0
            a = a + b


@pytest.mark.parametrize("backend", BACKENDS)
def test_nested_while(backend):
    st = build(nested_while, backend)
    a = np.array([[[1.0, 7.5]], [[9.0, 0.0]]])
    b = np.array([[[0.0, 3.5]], [[1.0, 4.0]]])
    exp_a, exp_b = a.copy(), b.copy()
    for i in np.ndindex(exp_a.shape):
        while exp_a[i] < 8.0:
            while exp_b[i] < 4.0:
                exp_b[i] += 1.0
            exp_a[i] += exp_b[i]
    st(a, b)
    np.testing.assert_allclose(a, exp_a)
    np.testing.assert_allclose(b, exp_b)


def test_with_clause_error_surfaces_cause():
    """Round-1 review weak #8: a typo inside a `with computation(...)`
    header must surface the underlying exception, not degrade to a generic
    "Invalid 'with' clause" (reference reports these precisely)."""

    def bad(a: Field3D):
        with computation(UNDEFINED_ORDER), interval(...):  # noqa: F821
            a = 1.0

    with pytest.raises(GTScriptSyntaxError, match="NameError.*UNDEFINED_ORDER"):
        gtscript.stencil(backend="numpy", definition=bad)


def test_function_multi_return():
    """gtscript.function returning a tuple unpacked in the stencil
    (reference gtscript_frontend multi-value returns)."""

    @gtscript.function
    def split_pm(x):
        return x + 1.0, x - 1.0

    def st(a: Field3D, p: Field3D, m: Field3D):
        with computation(PARALLEL), interval(...):
            p, m = split_pm(a)

    s = gtscript.stencil(backend="numpy", definition=st)
    a = storage.from_array(np.arange(8.0).reshape(2, 2, 2), backend="numpy")
    p = storage.zeros((2, 2, 2), backend="numpy")
    m = storage.zeros((2, 2, 2), backend="numpy")
    s(a, p, m)
    np.testing.assert_allclose(np.asarray(p), np.asarray(a) + 1.0)
    np.testing.assert_allclose(np.asarray(m), np.asarray(a) - 1.0)


def test_function_defaults_kwargs_nested():
    """Defaults, keyword arguments, and nested gtscript.function calls all
    inline (reference CallInliner breadth)."""

    @gtscript.function
    def axpb(x, a=2.0, b=1.0):
        return a * x + b

    @gtscript.function
    def twice_axpb(x):
        return axpb(axpb(x, b=0.5), a=3.0)

    def st(src: Field3D, dst: Field3D):
        with computation(PARALLEL), interval(...):
            dst = twice_axpb(src) + axpb(src, 1.0, 0.0)

    s = gtscript.stencil(backend="numpy", definition=st)
    src = storage.from_array(np.arange(8.0).reshape(2, 2, 2), backend="numpy")
    dst = storage.zeros((2, 2, 2), backend="numpy")
    s(src, dst)
    x = np.asarray(src)
    np.testing.assert_allclose(
        np.asarray(dst), (3.0 * (2.0 * x + 0.5) + 1.0) + x
    )


def test_table_lookup_inside_while():
    """GlobalTable lookups inside while loops (feature interaction)."""
    Table4 = gtscript.GlobalTable[(np.float64, (4,))]
    FieldI64 = gtscript.Field[np.int64]

    def s(idx: FieldI64, out: Field3D, tab: Table4):
        with computation(PARALLEL), interval(...):
            n = 0
            acc = 0.0
            while n < 3:
                acc = acc + tab[idx]
                n = n + 1
            out = acc

    rng = np.random.default_rng(5)
    idx_np = rng.integers(0, 4, (3, 3, 2)).astype(np.int64)
    tab_np = np.arange(4.0) + 1
    results = {}
    for b in ("numpy", "jax"):
        st = gtscript.stencil(backend=b, definition=s, name=f"tw_{b}")
        idx = storage.from_array(idx_np, backend=b)
        out = storage.zeros((3, 3, 2), backend=b)
        tab = storage.from_array(tab_np, backend=b)
        st(idx, out, tab)
        results[b] = np.asarray(out)
    np.testing.assert_allclose(results["jax"], results["numpy"])
    np.testing.assert_allclose(results["numpy"], 3.0 * tab_np[idx_np])


def test_variable_k_read_of_temporary():
    """Variable K offsets applied to computation temporaries."""
    FieldI64 = gtscript.Field[np.int64]

    def s(a: Field3D, kidx: FieldI64, out: Field3D):
        with computation(PARALLEL), interval(...):
            t = a * 2.0
            out = t[0, 0, kidx]

    rng = np.random.default_rng(6)
    a_np = rng.random((3, 3, 4))
    k_np = rng.integers(-1, 2, (3, 3, 4)).astype(np.int64)
    # arrays hoisted: both backends must see identical inputs
    results = {}
    for b in ("numpy", "jax"):
        st = gtscript.stencil(backend=b, definition=s, name=f"vkt_{b}")
        a = storage.from_array(a_np, backend=b)
        kidx = storage.from_array(k_np, backend=b)
        out = storage.zeros((3, 3, 4), backend=b)
        st(a, kidx, out)
        results[b] = np.asarray(out)
    np.testing.assert_allclose(results["jax"], results["numpy"], rtol=1e-12)


def test_data_dim_reads_in_sequential_carry():
    """Vector-field components consumed by a FORWARD carry chain."""
    Vec2 = gtscript.Field[(np.float64, (2,))]

    def s(v: Vec2, out: Field3D):
        with computation(FORWARD):
            with interval(0, 1):
                out = v[0, 0, 0][0]
            with interval(1, None):
                out = out[0, 0, -1] + v[0, 0, 0][1]

    rng = np.random.default_rng(7)
    v_np = rng.random((3, 3, 4, 2))
    results = {}
    for b in ("numpy", "jax"):
        st = gtscript.stencil(backend=b, definition=s, name=f"vseq_{b}")
        v = storage.from_array(v_np, backend=b)
        out = storage.zeros((3, 3, 4), backend=b)
        st(v, out)
        results[b] = np.asarray(out)
    expected = np.empty((3, 3, 4))
    expected[:, :, 0] = v_np[:, :, 0, 0]
    for k in range(1, 4):
        expected[:, :, k] = expected[:, :, k - 1] + v_np[:, :, k, 1]
    np.testing.assert_allclose(results["numpy"], expected, rtol=1e-12)
    np.testing.assert_allclose(results["jax"], expected, rtol=1e-12)


# --- current-K iterator access (reference gtc/gtir.py:68) --------------------


@pytest.mark.parametrize("backend", BACKENDS + ["debug", "gpu"])
def test_iterator_access_parallel(backend):
    """Bare K in an expression yields the absolute K iteration index."""

    def s(out: Field3D):
        with computation(PARALLEL), interval(...):
            out = K * 1.0

    st = build(s, backend)
    out = np.zeros((3, 4, 5))
    st(out)
    expected = np.broadcast_to(np.arange(5.0), (3, 4, 5))
    np.testing.assert_allclose(out, expected)


@pytest.mark.parametrize("backend", BACKENDS + ["debug", "gpu"])
def test_iterator_access_intervals(backend):
    """K is absolute (domain-based), not interval-relative."""

    def s(out: Field3D):
        with computation(PARALLEL):
            with interval(0, 2):
                out = K + 100
            with interval(2, None):
                out = K * 1.0

    st = build(s, backend)
    out = np.zeros((3, 3, 6))
    st(out)
    expected = np.broadcast_to(
        np.array([100.0, 101.0, 2.0, 3.0, 4.0, 5.0]), (3, 3, 6)
    )
    np.testing.assert_allclose(out, expected)


@pytest.mark.parametrize("backend", BACKENDS + ["debug", "gpu"])
def test_iterator_access_sequential(backend):
    """K-dependent coefficient inside a FORWARD carry chain (plane-scan in
    the jax backend, the K-sweep kernel on gpu)."""

    def s(out: Field3D):
        with computation(FORWARD):
            with interval(0, 1):
                out = K * 1.0
            with interval(1, None):
                out = out[0, 0, -1] + K

    st = build(s, backend)
    out = np.zeros((2, 2, 7))
    st(out)
    expected = np.broadcast_to(np.cumsum(np.arange(7.0)), (2, 2, 7))
    np.testing.assert_allclose(out, expected)


@pytest.mark.parametrize("backend", BACKENDS + ["debug", "gpu"])
def test_iterator_access_backward(backend):
    def s(out: Field3D):
        with computation(BACKWARD):
            with interval(-1, None):
                out = K * 1.0
            with interval(0, -1):
                out = out[0, 0, 1] + K

    st = build(s, backend)
    nk = 5
    out = np.zeros((2, 2, nk))
    st(out)
    expected_col = np.cumsum(np.arange(nk)[::-1].astype(float))[::-1]
    np.testing.assert_allclose(out, np.broadcast_to(expected_col, (2, 2, nk)))


@pytest.mark.parametrize("backend", BACKENDS + ["debug", "gpu"])
def test_iterator_access_in_condition(backend):
    """K in a branch condition masks per-level."""

    def s(a: Field3D, out: Field3D):
        with computation(PARALLEL), interval(...):
            if K >= 2:
                out = a
            else:
                out = -a

    st = build(s, backend)
    rng = np.random.default_rng(3)
    a = rng.random((3, 3, 5))
    out = np.zeros((3, 3, 5))
    st(a, out)
    expected = np.where(np.arange(5) >= 2, a, -a)
    np.testing.assert_allclose(out, expected)


def test_iterator_access_int_dtype():
    """K carries the literal_int_precision integer dtype (reference
    gtscript_frontend.py:1296-1298)."""
    from gt4py_tpu.cartesian import frontend

    def s(out: Field3D):
        with computation(PARALLEL), interval(...):
            out = K * 1.0

    ir = frontend.parse_stencil(s, {"literal_int_precision": 32})
    from gt4py_tpu import eve
    from gt4py_tpu.cartesian import gtir

    accesses = [
        n
        for _, _, stmt in ir.walk_stmts()
        for n in eve.walk_values(stmt)
        if isinstance(n, gtir.IteratorAccess)
    ]
    assert len(accesses) == 1
    assert accesses[0].dtype == np.dtype(np.int32)


def test_iterator_access_only_k():
    """I and J cannot be queried (reference gtscript_frontend.py:860)."""

    def s_i(out: Field3D):
        with computation(PARALLEL), interval(...):
            out = I * 1.0

    def s_j(out: Field3D):
        with computation(PARALLEL), interval(...):
            out = J * 1.0

    for s in (s_i, s_j):
        with pytest.raises(GTScriptSyntaxError, match="can't be queried"):
            build(s, "numpy")


def test_at_k_equals_k_rejected():
    """`.at(K=K)` is the identity read — rejected like the reference
    (gtscript_frontend.py:1696)."""

    def s(a: Field3D, out: Field3D):
        with computation(PARALLEL), interval(...):
            out = a.at(K=K)

    with pytest.raises(GTScriptSyntaxError, match="absolute index"):
        build(s, "numpy")


def test_iterator_access_variable_k_offset():
    """K composes into arithmetic used as a variable K offset index."""

    def s2(a: Field3D, kidx: gtscript.Field[gtscript.K, np.int64], out: Field3D):
        with computation(PARALLEL), interval(...):
            out = a[0, 0, kidx - K]  # relative offset back to absolute kidx

    st = build(s2, "numpy")
    rng = np.random.default_rng(5)
    a = rng.random((3, 3, 6))
    kidx = np.array([0, 0, 1, 1, 2, 2], dtype=np.int64)
    out = np.zeros((3, 3, 6))
    st(a, kidx, out)
    np.testing.assert_allclose(out, a[:, :, kidx])


# --- non-literal interval bounds (reference gtscript_frontend.py:130-153) ----


@pytest.mark.parametrize("backend", BACKENDS)
def test_interval_axis_index_bounds(backend):
    """interval(K[1] + 1, K[-1]) == interval(2, -1)."""

    def s(out: Field3D):
        with computation(PARALLEL):
            with interval(K[1] + 1, K[-1]):
                out = 1.0

    st = build(s, backend)
    out = np.zeros((2, 2, 6))
    st(out)
    expected = np.zeros((2, 2, 6))
    expected[:, :, 2:5] = 1.0
    np.testing.assert_allclose(out, expected)


@pytest.mark.parametrize("backend", BACKENDS)
def test_interval_externals_bounds(backend):
    """Externals-driven interval expressions resolve at compile time."""

    def s(out: Field3D):
        from __externals__ import KSTART, KDEPTH

        with computation(PARALLEL):
            with interval(KSTART, KSTART + KDEPTH):
                out = 2.0

    st = build(s, backend, externals={"KSTART": 1, "KDEPTH": 3})
    out = np.zeros((2, 2, 6))
    st(out)
    expected = np.zeros((2, 2, 6))
    expected[:, :, 1:4] = 2.0
    np.testing.assert_allclose(out, expected)


def test_interval_wrong_axis_bound_rejected():
    def s(out: Field3D):
        with computation(PARALLEL):
            with interval(I[0], None):
                out = 1.0

    with pytest.raises(GTScriptSyntaxError, match="K axis"):
        build(s, "numpy")


# --- optional fields (reference stencil_definitions.py optional_field) -------


def optional_field_defn(
    in_field: Field3D, out_field: Field3D, dyn_tend: Field3D,
    phys_tend: Field3D = None, *, dt: float,
):
    from __externals__ import PHYS_TEND

    with computation(PARALLEL), interval(...):
        out_field = in_field + dt * dyn_tend
        if __INLINED(PHYS_TEND):  # noqa: F821
            out_field = out_field + dt * phys_tend


@pytest.mark.parametrize("backend", BACKENDS)
def test_optional_field(backend):
    """A field pruned by __INLINED(False) may be omitted at call time
    (reference optional_field / two_optional_fields pattern)."""
    rng = np.random.default_rng(0)
    shape = (4, 4, 3)
    inf, dyn, phys = rng.random(shape), rng.random(shape), rng.random(shape)

    st_off = build(
        optional_field_defn, backend, externals={"PHYS_TEND": False},
        name=f"optoff_{backend}",
    )
    out = np.zeros(shape)
    st_off(inf, out, dyn, dt=0.5)  # phys_tend omitted entirely
    np.testing.assert_allclose(out, inf + 0.5 * dyn)

    st_on = build(
        optional_field_defn, backend, externals={"PHYS_TEND": True},
        name=f"opton_{backend}",
    )
    out2 = np.zeros(shape)
    st_on(inf, out2, dyn, phys, dt=0.5)
    np.testing.assert_allclose(out2, inf + 0.5 * (dyn + phys))


def test_optional_field_required_when_enabled():
    st = build(
        optional_field_defn, "numpy", externals={"PHYS_TEND": True},
        name="optreq",
    )
    shape = (3, 3, 2)
    with pytest.raises(ValueError, match="phys_tend"):
        st(np.zeros(shape), np.zeros(shape), np.zeros(shape), dt=0.5)
