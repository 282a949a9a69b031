"""Tridiagonal solve with FORWARD/BACKWARD computations (Thomas algorithm).

The canonical sequential-K workload (reference
stencil_definitions.py:220): on the gpu backend both sweeps run in the
K-sweep kernel, one thread per column with the recurrence carried in
registers (docs/performance.md). Run: python examples/tridiagonal_solver.py
"""

import numpy as np

import os, sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import BACKWARD, FORWARD, computation, interval

Field3D = gtscript.Field[np.float32]


@gtscript.stencil(backend="gpu", literal_float_precision=32)
def tridiagonal_solver(
    inf: Field3D, diag: Field3D, sup: Field3D, rhs: Field3D, out: Field3D
):
    with computation(FORWARD):
        with interval(0, 1):
            sup = sup / diag
            rhs = rhs / diag
        with interval(1, None):
            sup = sup / (diag - sup[0, 0, -1] * inf)
            rhs = (rhs - inf * rhs[0, 0, -1]) / (diag - sup[0, 0, -1] * inf)
    with computation(BACKWARD):
        with interval(-1, None):
            out = rhs
        with interval(0, -1):
            out = rhs - sup * out[0, 0, 1]


def main():
    shape = (64, 64, 48)
    # System with known solution x == 1: rhs = row sums of [-1, 3, 1].
    inf = storage.full(shape, -1.0, np.float32, backend="gpu")
    diag = storage.full(shape, 3.0, np.float32, backend="gpu")
    sup = storage.full(shape, 1.0, np.float32, backend="gpu")
    rhs_np = np.full(shape, 3.0, dtype=np.float32)
    rhs_np[:, :, 0] = 4.0   # first row: 3 + 1
    rhs_np[:, :, -1] = 2.0  # last row: -1 + 3
    rhs = storage.from_array(rhs_np, np.float32, backend="gpu")
    out = storage.zeros(shape, np.float32, backend="gpu")

    tridiagonal_solver(inf, diag, sup, rhs, out)
    result = np.asarray(out)
    print("max |x - 1| =", np.abs(result - 1.0).max())
    assert np.allclose(result, 1.0, atol=1e-5)
    print("OK")


if __name__ == "__main__":
    main()
