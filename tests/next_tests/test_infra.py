"""Tests for the next-layer infrastructure: errors, type system,
fingerprinting, compiled-programs pool, named collections, field utils."""

import numpy as np
import pytest

import gt4py_tpu.next as gtx
from gt4py_tpu.eve import SourceLocation
from gt4py_tpu.next import errors, fingerprinting, type_system as ts
from gt4py_tpu.next.common import Dimension, DimensionKind
from gt4py_tpu.next.field_utils import asnumpy
from gt4py_tpu.next.named_collections import extract, is_named_collection, named_collection
from gt4py_tpu.next.otf import CachedStep, CompilationOptions, Workflow, step

I = Dimension("I")
J = Dimension("J")
K = Dimension("K", kind=DimensionKind.VERTICAL)


# --- errors -----------------------------------------------------------------


def test_undefined_symbol_did_you_mean():
    err = errors.UndefinedSymbolError(None, "feild", ["field", "domain", "other"])
    assert "Did you mean 'field'?" in str(err)


def test_error_formatting_with_location(tmp_path):
    src = tmp_path / "prog.py"
    src.write_text("x = 1\ny = undefined_name + 2\n")
    loc = SourceLocation(line=2, column=4, filename=str(src), end_line=2, end_column=18)
    err = errors.DSLSyntaxError(loc, "Bad name")
    text = str(err)
    assert "Bad name" in text
    assert 'line 2' in text
    assert "^" in text


# --- type system ------------------------------------------------------------


def test_from_value_field_and_scalar():
    f = gtx.as_field({I: 4, J: 3}, np.zeros((4, 3), dtype=np.float32))
    spec = ts.from_value(f)
    assert spec == ts.FieldType(dims=(I, J), dtype=np.dtype(np.float32))
    assert ts.from_value(1.5) == ts.ScalarType(np.dtype(np.float64))
    assert ts.from_value(True) == ts.ScalarType(np.dtype(bool))
    tup = ts.from_value((f, 2))
    assert isinstance(tup, ts.TupleType) and len(tup.types) == 2
    assert str(spec) == "Field[[I, J], float32]"


def test_promote():
    assert ts.promote(
        ts.ScalarType(np.dtype(np.float32)), ts.ScalarType(np.dtype(np.int64))
    ) == ts.ScalarType(np.dtype(np.float64))


# --- fingerprinting ---------------------------------------------------------


def test_fingerprint_stability_and_sensitivity():
    def f(a):
        return a + 1

    def g(a):
        return a + 2

    assert fingerprinting.fingerprint_function(f) == fingerprinting.fingerprint_function(f)
    assert fingerprinting.fingerprint_function(f) != fingerprinting.fingerprint_function(g)
    assert fingerprinting.fingerprint(1, "x", (2.0,)) == fingerprinting.fingerprint(1, "x", (2.0,))
    assert fingerprinting.fingerprint(1) != fingerprinting.fingerprint(2)
    assert fingerprinting.fingerprint(I) != fingerprinting.fingerprint(K)


# --- compiled programs pool -------------------------------------------------


def test_pool_offset_provider_content_key():
    """Offset providers key the pool by CONTENT fingerprint, not id():
    a GC'd connectivity replaced by a different table at the same address
    must NOT reuse the compiled variant (reference hashes the provider,
    otf/compiled_program.py:495-539)."""
    from gt4py_tpu.next.common import Connectivity
    from gt4py_tpu.next.otf import _provider_fingerprint

    E = Dimension("E")
    V = Dimension("V")
    E2V = Dimension("E2V")

    def conn(table):
        return Connectivity(
            np.asarray(table, dtype=np.int32), domain_dims=(E, E2V), codomain=V
        )

    c1 = conn([[0, 1], [1, 2]])
    c2 = conn([[0, 1], [1, 2]])
    c3 = conn([[2, 1], [1, 0]])
    assert _provider_fingerprint(c1) == _provider_fingerprint(c2)  # same content
    assert _provider_fingerprint(c1) != _provider_fingerprint(c3)  # different table

    # id-aliasing scenario: same address, different content -> different key
    import gc

    addr_keys = {}
    for tbl in ([[0, 1], [1, 2]], [[2, 1], [1, 0]]):
        c = conn(tbl)
        addr_keys[_provider_fingerprint(c)] = id(c)
        del c
        gc.collect()
    assert len(addr_keys) == 2


def test_pool_reuses_and_respecializes():
    @gtx.field_operator
    def op(a, factor: float = 2.0):
        return a * factor

    a = gtx.as_field({I: 4}, np.arange(4, dtype=np.float64))
    out = gtx.zeros({I: 4}, dtype=np.float64)
    op(a, out=out)
    op(a, out=out)
    assert len(op._pool) == 1  # same signature + out geometry: cached
    b = gtx.as_field({I: 8}, np.arange(8, dtype=np.float64))
    out8 = gtx.zeros({I: 8}, dtype=np.float64)
    op(b, out=out8)
    assert len(op._pool) == 2  # new shape: new executable
    np.testing.assert_allclose(asnumpy(out), np.arange(4) * 2.0)


def test_static_params_bake_values():
    @gtx.field_operator
    def op(a, n: int = 1):
        return a * n

    op2 = op.with_compilation_options(static_params=("n",))
    assert op2.options.static_params == ("n",)
    a = gtx.as_field({I: 4}, np.ones(4))
    out = gtx.zeros({I: 4})
    op2(a, out=out, n=3)
    np.testing.assert_allclose(asnumpy(out), 3.0)
    op2(a, out=out, n=4)
    np.testing.assert_allclose(asnumpy(out), 4.0)
    assert len(op2._pool) == 2  # one executable per static value


def test_aot_compile_precompiles():
    @gtx.field_operator
    def op(a):
        return a + 1.0

    a = gtx.as_field({I: 4}, np.zeros(4))
    op.compile(a)
    assert len(op._pool) == 1
    out = gtx.zeros({I: 4})
    op(a, out=out)
    assert len(op._pool) == 1  # reused the AOT-compiled variant


def test_enable_jit_false_runs_eager():
    calls = []

    def defn(a):
        calls.append(1)
        return a

    op = gtx.field_operator(defn).with_compilation_options(enable_jit=False)
    a = gtx.as_field({I: 4}, np.zeros(4))
    out = gtx.zeros({I: 4})
    op(a, out=out)
    op(a, out=out)
    assert len(calls) == 2  # traced per call: eager path
    assert len(op._pool) == 0


# --- workflow kit -----------------------------------------------------------


def test_workflow_chain():
    wf = step(lambda x: x + 1).chain(lambda x: x * 10)
    assert wf(2) == 30


def test_cached_step(tmp_path):
    evals = []

    def expensive(x):
        evals.append(x)
        return x * x

    s = CachedStep(expensive, cache_dir=str(tmp_path / "wf"), name="sq")
    assert s(4) == 16
    assert s(4) == 16
    assert evals == [4]


# --- named collections ------------------------------------------------------


def test_named_collection_pytree():
    import jax

    @named_collection
    class State:
        rho: object
        vel: object

    a = gtx.as_field({I: 4}, np.arange(4, dtype=np.float64))
    b = gtx.as_field({I: 4}, np.ones(4))
    s = State(rho=a, vel=b)
    assert is_named_collection(s)
    assert extract(s, "rho") is a

    def bump(state):
        return State(rho=state.rho + 1.0, vel=state.vel)

    s2 = jax.jit(bump)(s)
    np.testing.assert_allclose(asnumpy(s2.rho.ndarray), np.arange(4) + 1.0)


# --- connectivity extensions --------------------------------------------------


def test_inverse_image():
    import numpy as np
    from gt4py_tpu.next.common import Connectivity, Dimension, UnitRange

    V = Dimension("V"); E = Dimension("E"); V2E = Dimension("V2E")
    table = np.array([[0, 1], [1, 2], [2, 3], [6, 7]])
    conn = Connectivity(table, domain_dims=(V, V2E), codomain=E)
    rng = conn.inverse_image(UnitRange(0, 4))
    assert (rng.start, rng.stop) == (0, 3)


def test_cartesian_connectivity_shift():
    import numpy as np
    import gt4py_tpu.next as gtx
    from gt4py_tpu.next.common import CartesianConnectivity, Dimension
    from gt4py_tpu.next.field_utils import asnumpy

    II = Dimension("II")
    f = gtx.as_field({II: 5}, np.arange(5.0))
    shifted = f(CartesianConnectivity(II, 1))
    # out(i) = f(i+1): domain shrinks/offsets; compare raw data
    assert shifted.domain[II].unit_range.start == -1
    np.testing.assert_allclose(asnumpy(shifted.ndarray), np.arange(5.0))


def test_promote_dims():
    from gt4py_tpu.next.common import Dimension, promote_dims

    A, B, C = Dimension("A"), Dimension("B"), Dimension("C")
    assert promote_dims((A, B), (B, C)) == (A, B, C)


def test_premap_and_restrict():
    import numpy as np
    import gt4py_tpu.next as gtx
    from gt4py_tpu.next.common import CartesianConnectivity, Dimension
    from gt4py_tpu.next.field_utils import asnumpy

    D = Dimension("D")
    f = gtx.as_field({D: 6}, np.arange(6.0))
    assert f.premap(CartesianConnectivity(D, 2)).domain[D].unit_range.start == -2
    r = f.restrict({D: (2, 5)})
    np.testing.assert_allclose(asnumpy(r.ndarray), [2.0, 3.0, 4.0])
    assert r.domain[D].unit_range.start == 2


def test_module_level_wait_for_compilation():
    import numpy as np

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next.common import Dimension

    I = Dimension("Iw")

    @gtx.field_operator
    def dbl(a):
        return a * 2.0

    op = dbl.with_compilation_options(async_compile=True)
    out = gtx.zeros({I: 4})
    op(gtx.as_field([I], np.arange(4.0)), out=out)
    gtx.wait_for_compilation()  # joins every live pool without error
    np.testing.assert_allclose(out.asnumpy(), 2 * np.arange(4.0))


def test_unit_range_helper():
    from gt4py_tpu.next import UnitRange, unit_range

    assert unit_range(5) == UnitRange(0, 5)
    assert unit_range((2, 6)) == UnitRange(2, 6)


def test_typing_module_exports():
    from gt4py_tpu.next import typing as nxt

    assert set(nxt.__all__) >= {
        "Backend", "FieldOperator", "Program", "OffsetProvider",
    }
    for name in nxt.__all__:
        assert getattr(nxt, name) is not None


def test_field_utils_coverage():
    import numpy as np

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next.common import Dimension
    from gt4py_tpu.next.field_utils import asnumpy, field_from_typespec, verify_device
    from gt4py_tpu.next.type_system import FieldType

    If = Dimension("If")
    f = gtx.as_field([If], np.arange(3.0))
    # asnumpy over tuples and raw arrays
    out = asnumpy((f, np.ones(2), (f,)))
    assert isinstance(out, tuple) and isinstance(out[0], np.ndarray)
    assert isinstance(out[2], tuple)
    # verify_device: jnp arrays on the CPU tier
    assert verify_device(f, "cpu")
    assert verify_device((f, f), "cpu")
    assert not verify_device(f, "gpu")
    assert verify_device(np.ones(2), "cpu")  # raw numpy counts as cpu
    # field_from_typespec
    spec = FieldType(dims=(If,), dtype=np.dtype(np.float32))
    z = field_from_typespec(spec, gtx.domain({If: 4}))
    assert z.dtype == np.dtype(np.float32) and z.shape == (4,)
    import pytest

    with pytest.raises(TypeError, match="FieldType"):
        field_from_typespec("nope", gtx.domain({If: 4}))


def test_named_collection_in_operators_and_jit():
    """Collections flow through operators and whole-program jit as one
    object (reference named_collections through compiled programs)."""
    import numpy as np

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next.common import Dimension
    from gt4py_tpu.next.named_collections import (
        constructor,
        extract,
        is_named_collection,
        named_collection,
    )

    Inc = Dimension("Inc")

    @named_collection
    class State:
        rho: object
        vel: object

    rho = gtx.as_field([Inc], np.arange(4.0))
    vel = gtx.as_field([Inc], np.ones(4))
    state = constructor(State)(rho=rho, vel=vel)
    assert is_named_collection(state)
    assert extract(state, "rho") is rho
    import pytest

    with pytest.raises(TypeError, match="not a named collection"):
        extract(3, "rho")
    with pytest.raises(TypeError, match="not a named collection"):
        constructor(int)

    @gtx.field_operator
    def momentum(s):
        return s.rho * s.vel + 1.0

    out = gtx.zeros({Inc: 4})
    momentum(state, out=out)
    np.testing.assert_allclose(out.asnumpy(), np.arange(4.0) + 1.0)


def test_raw_array_operator_arg_gets_actionable_error():
    import numpy as np
    import pytest

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next.common import Dimension

    Ir = Dimension("Ir")

    @gtx.field_operator
    def dbl(a):
        return a * 2.0

    out = gtx.zeros({Ir: 4})
    with pytest.raises(TypeError, match="as_field"):
        dbl(np.ones(4), out=out)


def test_field_operator_inspect_stages():
    """op.inspect() exposes the jaxpr/StableHLO/HLO artifacts (the
    ITIR-formatter observability analog, round-3 Missing #6)."""
    import numpy as np

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import Dimension

    I = Dimension("Iins")

    @gtx.field_operator
    def op(a, b):
        return a * 2.0 + b

    a = gtx.as_field([I], np.arange(8.0))
    b = gtx.as_field([I], np.ones(8))
    jx = op.inspect(a, b, stage="jaxpr")
    assert "mul" in jx and "add" in jx
    sh = op.inspect(a, b, stage="stablehlo")
    assert "stablehlo" in sh or "func" in sh
    hlo = op.inspect(a, b, stage="hlo")
    assert "fusion" in hlo or "HloModule" in hlo

    import pytest

    with pytest.raises(ValueError, match="Unknown stage"):
        op.inspect(a, b, stage="itir")
