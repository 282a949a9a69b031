"""Double-roundtrip of BRIDGED programs at the GTIR level.

The FOAST round-trip (test_double_roundtrip.py) validates the textual IR
at field-view granularity; this tier validates it one level BELOW: the
``gtir.Stencil`` the cartesian bridge lowers a field operator / scan
operator to is pretty-printed, re-parsed, compiled, and executed — the
result must match both the direct bridge execution and the embedded
oracle. This is the post-bridge, pre-XLA hand-authorable test point
(reference program_processors/runners/double_roundtrip.py role applied
to the lowered program, cf. iterator/pretty_printer.py+pretty_parser.py).
"""

import numpy as np
import pytest

import gt4py_tpu.next as gtx
from gt4py_tpu.cartesian import gtir_pretty
from gt4py_tpu.next import Dimension, DimensionKind, FieldOffset, where
from gt4py_tpu.next import cartesian_bridge as bridge
from gt4py_tpu.next.foast import exec_definition

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)
Ioff = FieldOffset("Ioff", source=IDim, target=(IDim,))
Joff = FieldOffset("Joff", source=JDim, target=(JDim,))
PROV = {"Ioff": IDim, "Joff": JDim}

BACKEND = "jax"  # CPU-safe cartesian backend; gpu shares the GTIR


def _text_roundtrip(stencil):
    text = gtir_pretty.pretty(stencil)
    back = gtir_pretty.parse(text)
    # printer is stable over its own parse (textual fixed point)
    assert gtir_pretty.pretty(back) == text
    return back


def _run_both(op, field_args, scalar_args, out_direct, out_rt):
    """Build the bridge variant directly AND through the textual GTIR
    round-trip; execute both into the given out fields."""
    defn = exec_definition(op)
    v_direct = bridge.build_variant(
        defn, field_args, scalar_args, out_direct, PROV, BACKEND
    )
    v_rt = bridge.build_variant(
        defn, field_args, scalar_args, out_rt, PROV, BACKEND,
        gtir_transform=_text_roundtrip,
    )
    bridge.execute(v_direct, field_args, scalar_args, out_direct)
    bridge.execute(v_rt, field_args, scalar_args, out_rt)


@gtx.field_operator
def lap(phi):
    return -4.0 * phi + phi(Ioff[1]) + phi(Ioff[-1]) + phi(Joff[1]) + phi(Joff[-1])


def test_lap_roundtrips_through_gtir_text():
    rng = np.random.default_rng(3)
    n = 12
    phi = gtx.as_field([IDim, JDim, KDim], rng.random((n, n, 4)))
    dom = {IDim: (1, n - 1), JDim: (1, n - 1), KDim: 4}
    out_d, out_rt = gtx.zeros(dom), gtx.zeros(dom)
    _run_both(lap, {"phi": phi}, {}, out_d, out_rt)
    np.testing.assert_array_equal(out_rt.asnumpy(), out_d.asnumpy())
    # and both match the embedded oracle
    out_e = gtx.zeros(dom)
    lap.with_backend(None)(phi, out=out_e, offset_provider=PROV)
    np.testing.assert_allclose(out_d.asnumpy(), out_e.asnumpy(), rtol=1e-13)


@gtx.field_operator
def flux_limited(inp, coeff):
    lap_f = 4.0 * inp - (inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1]))
    res = lap_f(Ioff[1]) - lap_f
    flx = where(res * (inp(Ioff[1]) - inp) > 0.0, 0.0, res)
    return inp - coeff * (flx - flx(Ioff[-1]))


def test_temporaries_and_where_roundtrip_through_gtir_text():
    """Exercises temporaries, shifted temporary reads, where-masks, and a
    scalar parameter in the bridged GTIR text form."""
    rng = np.random.default_rng(4)
    n = 16
    inp = gtx.as_field([IDim, JDim, KDim], rng.random((n, n, 3)))
    dom = {IDim: (2, n - 2), JDim: (2, n - 2), KDim: 3}
    out_d, out_rt = gtx.zeros(dom), gtx.zeros(dom)
    _run_both(flux_limited, {"inp": inp}, {"coeff": 0.3}, out_d, out_rt)
    np.testing.assert_array_equal(out_rt.asnumpy(), out_d.asnumpy())
    out_e = gtx.zeros(dom)
    flux_limited.with_backend(None)(inp, 0.3, out=out_e, offset_provider=PROV)
    np.testing.assert_allclose(out_d.asnumpy(), out_e.asnumpy(), rtol=1e-13)


@gtx.scan_operator(axis=KDim, forward=True, init=0.0)
def cumsum(carry: float, a: float) -> float:
    return carry + a


def test_scan_roundtrips_through_gtir_text():
    """Sequential two-section vertical loop (scan lowering) through the
    text form: the parsed stencil executes identically."""
    rng = np.random.default_rng(5)
    n, nk = 8, 6
    a = gtx.as_field([IDim, JDim, KDim], rng.random((n, n, nk)))
    dom = {IDim: n, JDim: n, KDim: nk}
    out_d, out_rt = gtx.zeros(dom), gtx.zeros(dom)
    v_direct = bridge.build_scan_variant(
        cumsum, {"a": a}, {}, out_d, PROV, BACKEND
    )
    v_rt = bridge.build_scan_variant(
        cumsum, {"a": a}, {}, out_rt, PROV, BACKEND,
        gtir_transform=_text_roundtrip,
    )
    bridge.execute(v_direct, {"a": a}, {}, out_d)
    bridge.execute(v_rt, {"a": a}, {}, out_rt)
    np.testing.assert_array_equal(out_rt.asnumpy(), out_d.asnumpy())
    np.testing.assert_allclose(
        out_d.asnumpy(), np.cumsum(a.asnumpy(), axis=2), rtol=1e-13
    )


def test_hand_edited_bridged_gtir_compiles():
    """The text form is hand-AUTHORABLE, not just a serialization: edit
    the bridged lap's pretty text (flip a literal) and the re-parsed
    stencil compiles and computes the edited program."""
    rng = np.random.default_rng(6)
    n = 10
    phi = gtx.as_field([IDim, JDim, KDim], rng.random((n, n, 2)))
    dom = {IDim: (1, n - 1), JDim: (1, n - 1), KDim: 2}

    captured = {}

    def capture(s):
        captured["text"] = gtir_pretty.pretty(s)
        return s

    out_tmp = gtx.zeros(dom)
    bridge.build_variant(
        exec_definition(lap), {"phi": phi}, {}, out_tmp, PROV, BACKEND,
        gtir_transform=capture,
    )
    assert "-4.0" in captured["text"] or "4.0" in captured["text"]
    edited = captured["text"].replace("4.0", "6.0")

    def inject(_s):
        return gtir_pretty.parse(edited)

    out_ed = gtx.zeros(dom)
    v = bridge.build_variant(
        exec_definition(lap), {"phi": phi}, {}, out_ed, PROV, BACKEND,
        gtir_transform=inject,
    )
    bridge.execute(v, {"phi": phi}, {}, out_ed)
    p = phi.asnumpy()
    ref = (-6.0 * p + np.roll(p, -1, 0) + np.roll(p, 1, 0)
           + np.roll(p, -1, 1) + np.roll(p, 1, 1))[1:-1, 1:-1, :]
    np.testing.assert_allclose(out_ed.asnumpy(), ref, rtol=1e-13)
