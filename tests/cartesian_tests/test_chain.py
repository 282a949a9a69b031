"""On-device chained execution (round-5 verdict item 5): ``stencil.chain``
runs the whole time loop as one executable with buffer rotation, matching
the user's Python loop exactly (the oracle below). Reference analog:
``FrozenStencil`` (/root/reference/src/gt4py/cartesian/stencil_object.py:95)
is the per-call overhead floor; chain removes the calls themselves."""

import numpy as np
import pytest

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import FORWARD, PARALLEL, computation, interval

Field3F = gtscript.Field[np.float32]

BACKENDS = ["numpy", "jax", "gpu"]


def smooth_defn(in_field: Field3F, out_field: Field3F, w: np.float32):
    with computation(PARALLEL), interval(...):
        out_field = (1.0 - w) * in_field + w * 0.25 * (
            in_field[1, 0, 0]
            + in_field[-1, 0, 0]
            + in_field[0, 1, 0]
            + in_field[0, -1, 0]
        )


def oracle_chain(st, n_steps, fields, swap, **call_kw):
    """The documented equivalence: plain loop + role rotation."""
    fields = dict(fields)
    for _ in range(n_steps):
        st(**fields, **call_kw)
        fields = {r: fields[swap.get(r, r)] for r in fields}
    return fields


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n_steps", [1, 2, 11])
def test_chain_pingpong_matches_loop(backend, n_steps):
    st = gtscript.stencil(
        backend=backend, definition=smooth_defn, literal_float_precision=32
    )
    rng = np.random.default_rng(3)
    shape = (14, 14, 4)
    dom = dict(origin=(1, 1, 0), domain=(12, 12, 4), w=np.float32(0.6))
    swap = {"in_field": "out_field", "out_field": "in_field"}

    src = rng.random(shape, dtype=np.float32)

    # oracle on the numpy backend
    st_np = gtscript.stencil(
        backend="numpy", definition=smooth_defn, literal_float_precision=32
    )
    a_o = storage.from_array(src, backend="numpy")
    b_o = storage.zeros(shape, np.float32, backend="numpy")
    final = oracle_chain(
        st_np, n_steps, {"in_field": a_o, "out_field": b_o}, swap, **dom
    )

    a = storage.from_array(src, backend=backend)
    b = storage.zeros(shape, np.float32, backend=backend)
    st.chain(n_steps, a, b, swap=swap, origin=dom["origin"], domain=dom["domain"],
             w=dom["w"])
    np.testing.assert_allclose(
        np.asarray(a), np.asarray(final["in_field"]), rtol=2e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(b), np.asarray(final["out_field"]), rtol=2e-6, atol=1e-6
    )


@pytest.mark.parametrize("backend", BACKENDS)
def test_chain_inout_accumulates_without_swap(backend):
    def accum(acc: Field3F, inc: Field3F):
        with computation(PARALLEL), interval(...):
            acc = acc + inc

    st = gtscript.stencil(
        backend=backend, definition=accum, literal_float_precision=32
    )
    rng = np.random.default_rng(5)
    shape = (8, 8, 3)
    inc_np = rng.random(shape, dtype=np.float32)
    acc = storage.zeros(shape, np.float32, backend=backend)
    inc = storage.from_array(inc_np, backend=backend)
    st.chain(10, acc, inc)
    np.testing.assert_allclose(np.asarray(acc), 10.0 * inc_np, rtol=2e-5)


@pytest.mark.parametrize("backend", ["jax", "gpu"])
def test_chain_forward_scan_pingpong(backend):
    """Sequential-K stencils chain too (the K-sweep kernel on ``gpu``)."""

    def cum(inp: Field3F, out: Field3F):
        with computation(FORWARD):
            with interval(0, 1):
                out = inp
            with interval(1, None):
                out = out[0, 0, -1] + 0.5 * inp

    st = gtscript.stencil(backend=backend, definition=cum, literal_float_precision=32)
    st_np = gtscript.stencil(
        backend="numpy", definition=cum, literal_float_precision=32
    )
    rng = np.random.default_rng(7)
    shape = (6, 6, 5)
    src = rng.random(shape, dtype=np.float32)
    swap = {"inp": "out", "out": "inp"}

    a_o = storage.from_array(src, backend="numpy")
    b_o = storage.zeros(shape, np.float32, backend="numpy")
    final = oracle_chain(st_np, 4, {"inp": a_o, "out": b_o}, swap)

    a = storage.from_array(src, backend=backend)
    b = storage.zeros(shape, np.float32, backend=backend)
    st.chain(4, a, b, swap=swap)
    np.testing.assert_allclose(np.asarray(a), np.asarray(final["inp"]), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(b), np.asarray(final["out"]), rtol=2e-5)


def test_chain_three_cycle_rotation():
    """Cycle length 3 (e.g. leapfrog-style u_prev/u/u_next rotation)."""

    def step3(u_prev: Field3F, u: Field3F, u_next: Field3F):
        with computation(PARALLEL), interval(...):
            u_next = 0.5 * u + 0.5 * u_prev

    st = gtscript.stencil(
        backend="jax", definition=step3, literal_float_precision=32
    )
    st_np = gtscript.stencil(
        backend="numpy", definition=step3, literal_float_precision=32
    )
    rng = np.random.default_rng(9)
    shape = (5, 5, 2)
    p0 = rng.random(shape, dtype=np.float32)
    u0 = rng.random(shape, dtype=np.float32)
    swap = {"u_prev": "u", "u": "u_next", "u_next": "u_prev"}

    fo = {
        "u_prev": storage.from_array(p0, backend="numpy"),
        "u": storage.from_array(u0, backend="numpy"),
        "u_next": storage.zeros(shape, np.float32, backend="numpy"),
    }
    final = oracle_chain(st_np, 7, fo, swap)

    f = {
        "u_prev": storage.from_array(p0, backend="jax"),
        "u": storage.from_array(u0, backend="jax"),
        "u_next": storage.zeros(shape, np.float32, backend="jax"),
    }
    st.chain(7, **f, swap=swap)
    for r in f:
        np.testing.assert_allclose(
            np.asarray(f[r]), np.asarray(final[r]), rtol=2e-6, atol=1e-6
        )


def test_chain_validation_errors():
    st = gtscript.stencil(
        backend="jax", definition=smooth_defn, literal_float_precision=32
    )
    shape = (8, 8, 3)
    a = storage.ones(shape, np.float32, backend="jax")
    b = storage.zeros(shape, np.float32, backend="jax")

    geom = dict(origin=(1, 1, 0), domain=(6, 6, 3), w=np.float32(0.5))
    with pytest.raises(ValueError, match="permutation"):
        st.chain(2, a, b, swap={"in_field": "out_field"}, **geom)
    with pytest.raises(ValueError, match="not fields"):
        st.chain(2, a, b, swap={"nope": "nope"}, **geom)
    c = storage.zeros((9, 8, 3), np.float32, backend="jax")
    with pytest.raises(ValueError, match="agree in shape"):
        st.chain(
            2, a, c,
            swap={"in_field": "out_field", "out_field": "in_field"},
            **geom,
        )
    with pytest.raises(ValueError, match="n_steps"):
        st.chain(-1, a, b, **geom)


def test_chain_zero_steps_is_noop():
    st = gtscript.stencil(
        backend="jax", definition=smooth_defn, literal_float_precision=32
    )
    shape = (8, 8, 3)
    a = storage.ones(shape, np.float32, backend="jax")
    b = storage.zeros(shape, np.float32, backend="jax")
    st.chain(0, a, b, origin=(1, 1, 0), domain=(6, 6, 3), w=np.float32(0.5))
    np.testing.assert_allclose(np.asarray(b), 0.0)
