"""Extent / Boundary / AccessKind / FieldInfo algebra unit tests
(reference tests/cartesian_tests/unit_tests/test_gtc/test_definitions.py:
the reference exercises its Extent/Boundary frame arithmetic heavily —
these quantities size every halo and kernel block)."""

import numpy as np
import pytest

from gt4py_tpu.cartesian.definitions import (
    AccessKind,
    Boundary,
    Extent,
    FieldInfo,
)


# --- AccessKind ---------------------------------------------------------------


def test_access_kind_flags():
    assert AccessKind.READ | AccessKind.WRITE == AccessKind.READ_WRITE
    assert AccessKind.READ_WRITE & AccessKind.READ
    assert not (AccessKind.NONE & AccessKind.READ)
    acc = AccessKind.NONE
    acc |= AccessKind.READ
    acc |= AccessKind.WRITE
    assert acc == AccessKind.READ_WRITE


# --- Extent -------------------------------------------------------------------


def test_extent_zeros_and_union():
    z = Extent.zeros()
    assert z.i == z.j == z.k == (0, 0)
    a = Extent(i=(-1, 2), j=(0, 0), k=(-3, 0))
    b = Extent(i=(0, 1), j=(-2, 1), k=(0, 4))
    u = a.union(b)
    assert u == Extent(i=(-1, 2), j=(-2, 1), k=(-3, 4))
    # union is commutative and idempotent
    assert b.union(a) == u
    assert u.union(u) == u


def test_extent_shifted_ij():
    e = Extent(i=(-1, 1), j=(0, 2))
    s = e.shifted_ij(3, -1)
    assert s.i == (2, 4)
    assert s.j == (-1, 1)
    assert s.k == (0, 0)  # K untouched by horizontal shifts


def test_extent_clamped_includes_zero():
    e = Extent(i=(1, 3), j=(-4, -2), k=(0, 0))
    c = e.clamped()
    assert c.i == (0, 3)
    assert c.j == (-4, 0)


def test_extent_boundary_conversion():
    e = Extent(i=(-2, 1), j=(0, 3), k=(-1, 0))
    b = e.boundary
    assert b.lower == (2, 0, 1)
    assert b.upper == (1, 3, 0)


def test_extent_boundary_ignores_positive_lower():
    # A read that only looks forward needs no lower halo.
    e = Extent(i=(1, 2))
    assert e.boundary.lower == (0, 0, 0)
    assert e.boundary.upper == (2, 0, 0)


# --- Boundary -----------------------------------------------------------------


def test_boundary_union_is_max():
    a = Boundary(lower=(1, 0, 2), upper=(0, 3, 0))
    b = Boundary(lower=(0, 2, 1), upper=(1, 1, 1))
    u = a.union(b)
    assert u.lower == (1, 2, 2)
    assert u.upper == (1, 3, 1)


# --- FieldInfo ----------------------------------------------------------------


def test_field_info_masks_and_ndim():
    fi = FieldInfo(
        access=AccessKind.READ,
        boundary=Boundary(),
        axes=("I", "K"),
        data_dims=(3,),
        dtype=np.dtype(np.float32),
    )
    assert fi.domain_mask == (True, False, True)
    assert fi.domain_ndim == 2
    assert fi.ndim == 3


def test_field_info_full_3d():
    fi = FieldInfo(
        access=AccessKind.READ_WRITE,
        boundary=Boundary(lower=(1, 1, 0), upper=(1, 1, 0)),
        axes=("I", "J", "K"),
        data_dims=(),
        dtype=np.dtype(np.float64),
    )
    assert fi.domain_mask == (True, True, True)
    assert fi.ndim == 3


# --- analysis integration: extents derived from real stencils -----------------


def test_field_extents_from_analysis():
    from gt4py_tpu.cartesian.passes import analyze
    from tests.cartesian_tests import stencil_defs as defs

    analyzed = analyze(
        defs.horizontal_diffusion, {"externals": {}, "dtypes": {}, "backend": "numpy"}
    )
    b = analyzed.field_infos["in_field"].boundary
    # hdiff reads in_field through lap(+-1) and flx/fly chains: halo 2.
    assert b.lower[:2] == (2, 2)
    assert b.upper[:2] == (2, 2)
    out_b = analyzed.field_infos["out_field"].boundary
    assert out_b.lower == (0, 0, 0) and out_b.upper == (0, 0, 0)


def test_sequential_k_extent_from_analysis():
    from gt4py_tpu.cartesian.passes import analyze
    from tests.cartesian_tests import stencil_defs as defs

    analyzed = analyze(
        defs.tridiagonal_solver, {"externals": {}, "dtypes": {}, "backend": "numpy"}
    )
    # Carried reads at [0,0,-1]/[0,0,1] stay within the sequential loop:
    # no K halo is demanded from the caller.
    for info in analyzed.field_infos.values():
        assert info.boundary.lower[2] == 0
        assert info.boundary.upper[2] == 0


def test_pallas_native_gap_matrix_populated():
    """The matrix records which constructs keep a sequential section off
    the ``gpu`` backend's K-sweep kernel, rather than being an empty
    mechanism."""
    from tests.cartesian_tests.definitions import (
        BACKEND_SKIP_TEST_MATRIX,
        USES_FLOAT64,
        USES_HORIZONTAL_REGION,
        XLA_FALLBACK,
        expects_native_kernel,
    )

    table = BACKEND_SKIP_TEST_MATRIX["gpu"]
    assert table, "kernel gaps must be recorded"
    assert table[USES_HORIZONTAL_REGION] == XLA_FALLBACK
    assert not expects_native_kernel("gpu", USES_HORIZONTAL_REGION)
    assert expects_native_kernel("gpu", "uses_scan")
    # float64 runs in the kernel on the GPU
    assert expects_native_kernel("gpu", USES_FLOAT64)
    # every other backend serves everything
    assert BACKEND_SKIP_TEST_MATRIX["numpy"] == {}
