"""Isentropic diagnostics model family (reference
demo_isentropic_diagnostics): FORWARD pressure + PARALLEL Exner +
BACKWARD Montgomery/height in one stencil, vs a NumPy oracle."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from examples.isentropic_diagnostics import run  # noqa: E402


@pytest.mark.parametrize("backend", ["numpy", "jax", "gpu"])
def test_isentropic_diagnostics_match_oracle(backend):
    errs, _ = run(backend=backend, nx=10, ny=18, nz=16, verbose=False)
    for name, err in errs.items():
        assert err < 1e-10, (name, err)


def test_isentropic_mountain_shapes_height_field():
    _, stor = run(backend="jax", nx=16, ny=16, nz=12, verbose=False)
    h = np.asarray(stor["h"])
    # the bell-shaped mountain lifts the bottom isentrope at the center
    assert h[8, 8, -1] > h[0, 0, -1]
    # heights decrease monotonically downward through the column
    assert np.all(np.diff(h[8, 8, :]) <= 0.0)
