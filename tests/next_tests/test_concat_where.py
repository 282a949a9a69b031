"""concat_where: domain-region concatenation semantics.

Ported from the reference feature suite
(tests/next_tests/integration_tests/feature_tests/ffront_tests/
test_concat_where.py): each operand only needs to cover its own region;
the result is the concatenation of the contributed slices along the
condition dimension (NOT an element-wise mask — that is ``where``).
"""

import numpy as np
import pytest

import gt4py_tpu.next as gtx
from gt4py_tpu.next import broadcast
from gt4py_tpu.next.experimental import concat_where

IDim = gtx.Dimension("IDim")
JDim = gtx.Dimension("JDim")
KDim = gtx.Dimension("KDim", kind=gtx.DimensionKind.VERTICAL)

NI, NJ, NK = 5, 6, 8


@pytest.fixture
def rng():
    return np.random.default_rng(40)


def ijk(rng, k=NK):
    return gtx.as_field([IDim, JDim, KDim], rng.random((NI, NJ, k)))


def test_concat_where_simple(rng):
    @gtx.field_operator
    def testee(ground, air):
        return concat_where(KDim > 0, air, ground)

    ground, air = ijk(rng), ijk(rng)
    out = gtx.zeros({IDim: NI, JDim: NJ, KDim: NK})
    testee(ground, air, out=out)
    k = np.arange(NK)
    ref = np.where(k[None, None, :] == 0, ground.asnumpy(), air.asnumpy())
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_concat_where_non_overlapping(rng):
    """Fields only defined in their respective region."""

    @gtx.field_operator
    def testee(ground, air):
        return concat_where(KDim == 0, ground, air)

    ground = gtx.as_field({IDim: NI, JDim: NJ, KDim: (0, 1)}, rng.random((NI, NJ, 1)))
    air = gtx.as_field({IDim: NI, JDim: NJ, KDim: (1, NK)}, rng.random((NI, NJ, NK - 1)))
    out = gtx.zeros({IDim: NI, JDim: NJ, KDim: NK})
    testee(ground, air, out=out)
    ref = np.concatenate((ground.asnumpy(), air.asnumpy()), axis=2)
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_concat_where_empty_branch(rng):
    @gtx.field_operator
    def testee(a, b):
        return concat_where(IDim < NI + 1, a, b * 2.0)

    a, b = ijk(rng), ijk(rng)
    out = gtx.zeros({IDim: NI, JDim: NJ, KDim: NK})
    testee(a, b, out=out)
    np.testing.assert_array_equal(out.asnumpy(), a.asnumpy())


def test_concat_where_scalar_broadcast(rng):
    @gtx.field_operator
    def testee(b):
        return concat_where(KDim < NK - 1, 3.0, b)

    b = ijk(rng)
    out = gtx.zeros({IDim: NI, JDim: NJ, KDim: NK})
    testee(b, out=out)
    ref = np.concatenate(
        (np.full((NI, NJ, NK - 1), 3.0), b.asnumpy()[:, :, -1:]), axis=2
    )
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_concat_where_scalar_on_empty_branch(rng):
    """Out domain such that the scalar branch is never active."""

    @gtx.field_operator
    def testee(b):
        return concat_where(KDim < 1, 3.0, b)

    b = gtx.as_field([KDim], rng.random(NK))
    out = gtx.zeros({KDim: (1, NK)})
    testee(b, out=out)
    np.testing.assert_array_equal(out.asnumpy(), b.asnumpy()[1:])


def test_concat_where_single_level_broadcast(rng):
    """A K-only field broadcasts across the horizontal dims of the other
    branch."""

    @gtx.field_operator
    def testee(a, b):
        return concat_where(KDim == 0, a, b)

    a = gtx.as_field([KDim], rng.random(NK))
    b = gtx.as_field({IDim: NI, JDim: NJ, KDim: (1, NK)}, rng.random((NI, NJ, NK - 1)))
    out = gtx.zeros({IDim: NI, JDim: NJ, KDim: NK})
    testee(a, b, out=out)
    ref = np.concatenate(
        (np.tile(a.asnumpy()[0], (NI, NJ, 1)), b.asnumpy()), axis=2
    )
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_concat_where_single_level_restricted_domain_broadcast(rng):
    """The single-level branch field contains only ONE value (K: 0..1)."""

    @gtx.field_operator
    def testee(a, b):
        return concat_where(KDim == 0, a, b)

    a = gtx.as_field({KDim: (0, 1)}, rng.random(1))
    b = gtx.as_field({IDim: NI, JDim: NJ, KDim: (1, NK)}, rng.random((NI, NJ, NK - 1)))
    out = gtx.zeros({IDim: NI, JDim: NJ, KDim: NK})
    testee(a, b, out=out)
    ref = np.concatenate(
        (np.tile(a.asnumpy()[0], (NI, NJ, 1)), b.asnumpy()), axis=2
    )
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_boundary_single_layer_2d_bc(rng):
    """An IJ field (no K dim) supplies the K==0 boundary."""

    @gtx.field_operator
    def testee(interior, boundary):
        return concat_where(KDim == 0, boundary, interior)

    interior = ijk(rng)
    boundary = gtx.as_field([IDim, JDim], rng.random((NI, NJ)))
    out = gtx.zeros({IDim: NI, JDim: NJ, KDim: NK})
    testee(interior, boundary, out=out)
    k = np.arange(NK)
    ref = np.where(
        k[None, None, :] == 0, boundary.asnumpy()[:, :, None], interior.asnumpy()
    )
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_boundary_single_layer_2d_bc_on_empty_branch(rng):
    @gtx.field_operator
    def testee(interior, boundary):
        return concat_where(KDim == 0, boundary, interior)

    interior = ijk(rng)
    boundary = gtx.as_field([IDim, JDim], rng.random((NI, NJ)))
    out = gtx.zeros({IDim: NI, JDim: NJ, KDim: (1, NK)})
    testee(interior, boundary, out=out)
    np.testing.assert_array_equal(out.asnumpy(), interior.asnumpy()[:, :, 1:])


def test_nested_conditions(rng):
    @gtx.field_operator
    def testee(interior, boundary):
        return concat_where(
            KDim < 2, boundary, concat_where(KDim >= 5, boundary, interior)
        )

    interior, boundary = ijk(rng), ijk(rng)
    out = gtx.zeros({IDim: NI, JDim: NJ, KDim: NK})
    testee(interior, boundary, out=out)
    k = np.arange(NK)
    ref = np.where(
        (k[None, None, :] < 2) | (k[None, None, :] >= 5),
        boundary.asnumpy(),
        interior.asnumpy(),
    )
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_two_conditions_and(rng):
    nlev = NK

    @gtx.field_operator
    def testee(interior, boundary):
        return concat_where((0 < KDim) & (KDim < nlev - 1), interior, boundary)

    interior = gtx.as_field([KDim], rng.random(NK))
    boundary = gtx.as_field([KDim], rng.random(NK))
    out = gtx.zeros({KDim: NK})
    testee(interior, boundary, out=out)
    k = np.arange(NK)
    ref = np.where((0 < k) & (k < nlev - 1), interior.asnumpy(), boundary.asnumpy())
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_two_conditions_or(rng):
    @gtx.field_operator
    def testee(interior, boundary):
        return concat_where((KDim < 2) | (KDim >= 5), boundary, interior)

    interior = gtx.as_field([KDim], rng.random(NK))
    boundary = gtx.as_field([KDim], rng.random(NK))
    out = gtx.zeros({KDim: NK})
    testee(interior, boundary, out=out)
    k = np.arange(NK)
    ref = np.where((k < 2) | (k >= 5), boundary.asnumpy(), interior.asnumpy())
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_eq_in_middle_of_domain(rng):
    @gtx.field_operator
    def testee(interior, boundary):
        return concat_where(KDim == 2, interior, boundary)

    interior = gtx.as_field([KDim], rng.random(NK))
    boundary = gtx.as_field([KDim], rng.random(NK))
    out = gtx.zeros({KDim: NK})
    testee(interior, boundary, out=out)
    k = np.arange(NK)
    ref = np.where(k == 2, interior.asnumpy(), boundary.asnumpy())
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_np_integer_bound(rng):
    """Runtime-typed (np.int32) bounds build conditions too (reference
    passes N as an np.int32 program argument)."""
    n = np.int32(3)

    @gtx.field_operator
    def testee(a, b):
        return concat_where(KDim < n, a, b)

    a = gtx.as_field([KDim], rng.random(NK))
    b = gtx.as_field([KDim], rng.random(NK))
    out = gtx.zeros({KDim: NK})
    testee(a, b, out=out)
    k = np.arange(NK)
    np.testing.assert_array_equal(
        out.asnumpy(), np.where(k < 3, a.asnumpy(), b.asnumpy())
    )


def test_lap_like_horizontal(rng):
    """Nested horizontal concat_where builds a boundary frame
    (reference test_lap_like)."""
    ni, nj = 6, 7

    @gtx.field_operator
    def testee(inp):
        return concat_where(
            IDim == 0,
            0.0,
            concat_where(
                IDim == ni - 1,
                0.0,
                concat_where(
                    JDim == 0, 0.0, concat_where(JDim == nj - 1, 0.0, inp)
                ),
            ),
        )

    inp = gtx.as_field([IDim, JDim], rng.random((ni, nj)))
    out = gtx.zeros({IDim: ni, JDim: nj})
    testee(inp, out=out)
    ref = inp.asnumpy().copy()
    ref[0, :] = 0.0
    ref[-1, :] = 0.0
    ref[:, 0] = 0.0
    ref[:, -1] = 0.0
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_non_contiguous_raises(rng):
    a = gtx.as_field({KDim: (0, 2)}, rng.random(2))
    b = gtx.as_field({KDim: (5, NK)}, rng.random(NK - 5))
    with pytest.raises(ValueError, match="contiguous|gap"):
        concat_where(KDim < 2, a, b)


def test_condition_region_algebra():
    from gt4py_tpu.next.common import UnitRange

    c = (KDim < 2) | (KDim >= 5)
    assert UnitRange(5, 6).intersection(c.regions[-1]) == UnitRange(5, 6)
    both = (0 < KDim) & (KDim < 4)
    assert both.regions == (UnitRange(1, 4),)
    inv = ~both
    assert 0 in inv.regions[0] and 4 in inv.regions[-1]


def test_concat_where_bridged_sections(rng):
    """Through the cartesian bridge, vertical concat_where lowers to
    K-interval sections (specialized straight-line code, no masks)."""

    @gtx.field_operator(backend="gpu")
    def bc(phi, psi):
        return concat_where(
            KDim == 0, phi * 2.0, concat_where(KDim == NK - 1, psi * 3.0, 0.5 * (phi + psi))
        )

    p, q = rng.random((NI, NJ, NK)), rng.random((NI, NJ, NK))
    fp = gtx.as_field([IDim, JDim, KDim], p)
    fq = gtx.as_field([IDim, JDim, KDim], q)
    out = gtx.zeros({IDim: NI, JDim: NJ, KDim: NK})
    bc(fp, fq, out=out)

    var = next(v for v in bc._bridge_cache.values() if v is not None)
    from gt4py_tpu.cartesian.gtir_pretty import pretty

    text = pretty(var.backend.analyzed.stencil)
    assert "?" not in text  # sections, not per-point selects
    ref = 0.5 * (p + q)
    ref[..., 0] = p[..., 0] * 2.0
    ref[..., -1] = q[..., -1] * 3.0
    np.testing.assert_allclose(out.asnumpy(), ref, rtol=1e-12)

    # embedded path agrees
    out_e = gtx.zeros({IDim: NI, JDim: NJ, KDim: NK})
    bc.with_backend(None)(fp, fq, out=out_e)
    np.testing.assert_allclose(out_e.asnumpy(), ref, rtol=1e-12)
