"""Backend tiers and the test-exclusion matrix.

Counterpart of the reference's ``tests/cartesian_tests/definitions.py:34-54``
(backend lists derived from the live registry) and the exclusion-matrix
pattern of ``tests/next_tests/definitions.py:124-208`` (feature markers
mapped to per-backend skips, reference ADR 0015): tests declare the
features they exercise; whether a backend runs, xfails, or skips comes
from ONE central table instead of scattered ``skipif``s.
"""

from __future__ import annotations

import pytest

from gt4py_tpu.cartesian.backend.base import REGISTRY


ALL_BACKENDS = sorted(REGISTRY)
#: backends with no hand-written kernel; ``gpu`` (its K-sweep kernel runs in
#: the Pallas interpreter here) is covered by its own modules
CPU_BACKENDS = [b for b in ALL_BACKENDS if b != "gpu"]
# Reference: every backend except the pure-python oracles is "performance".
PERFORMANCE_BACKENDS = [b for b in ALL_BACKENDS if b not in ("debug", "numpy")]

# --- feature markers ---------------------------------------------------------

USES_SCAN = "uses_scan"
USES_WHILE = "uses_while"
USES_DATA_DIMS = "uses_data_dims"
USES_GLOBAL_TABLE = "uses_global_table"
USES_VARIABLE_K_OFFSET = "uses_variable_k_offset"
USES_ABSOLUTE_K = "uses_absolute_k"
USES_HORIZONTAL_REGION = "uses_horizontal_region"
USES_FLOAT64 = "uses_float64"

SKIP = "skip"
XFAIL = "xfail"
#: the construct executes CORRECTLY but through the XLA fallback — tests
#: asserting native-kernel service must not require it
XLA_FALLBACK = "xla_fallback"

#: backend -> {feature marker -> SKIP | XFAIL | XLA_FALLBACK}. Results are
#: correct on every backend; the ``gpu`` entries record which constructs in
#: a FORWARD/BACKWARD section keep it off the K-sweep kernel
#: (ksweep_triton.unsupported and the plane-scan gates; reference pattern:
#: tests/next_tests/definitions.py:124-208, ADR 0015).
BACKEND_SKIP_TEST_MATRIX: dict[str, dict[str, str]] = {b: {} for b in ALL_BACKENDS}
BACKEND_SKIP_TEST_MATRIX["gpu"] = {
    USES_WHILE: XLA_FALLBACK,
    USES_DATA_DIMS: XLA_FALLBACK,
    USES_GLOBAL_TABLE: XLA_FALLBACK,
    USES_VARIABLE_K_OFFSET: XLA_FALLBACK,
    USES_ABSOLUTE_K: XLA_FALLBACK,
    # tiles do not know their position in the domain
    USES_HORIZONTAL_REGION: XLA_FALLBACK,
}


def apply_exclusion(backend: str, *features: str) -> None:
    """Skip/xfail the current test according to the matrix."""
    table = BACKEND_SKIP_TEST_MATRIX.get(backend, {})
    for feature in features:
        action = table.get(feature)
        if action == SKIP:
            pytest.skip(f"{backend} does not support {feature}")
        if action == XFAIL:
            pytest.xfail(f"{backend} known-broken for {feature}")


def expects_native_kernel(backend: str, *features: str) -> bool:
    """False when any feature is served by the XLA fallback on this
    backend — strategy-assertion tests use this instead of hardcoding."""
    table = BACKEND_SKIP_TEST_MATRIX.get(backend, {})
    return not any(table.get(f) == XLA_FALLBACK for f in features)
