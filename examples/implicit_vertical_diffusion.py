"""Implicit vertical diffusion — a column-physics example of the fused
scan-composition path.

The backward-Euler step ``(I - dt L) q_new = q_old`` with a tridiagonal
vertical Laplacian is the canonical implicit column solve of atmospheric
physics parameterizations (the reference exercises the same algebra in
test_vertical_advection / tridiagonal suites). Written in the field view
as two scan operators composed inside one field operator, it compiles to a
SINGLE cartesian stencil whose forward/backward sweeps run on the K-sweep
kernel with the modified coefficients in register carries
(next/cartesian_bridge.py trace_scan).

Run:  python examples/implicit_vertical_diffusion.py
"""

import numpy as np

import gt4py_tpu.next as gtx
from gt4py_tpu.next import Dimension, DimensionKind, where

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)


@gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
def thomas_forward(carry, a: float, b: float, c: float, d: float):
    """Modified-coefficient sweep: cp/dp stay in the carry (registers)."""
    cp_prev, dp_prev = carry
    denom = b - a * cp_prev
    return (c / denom, (d - a * dp_prev) / denom)


@gtx.scan_operator(axis=KDim, forward=False, init=0.0)
def thomas_backward(x_kp1, cp: float, dp: float):
    return dp - cp * x_kp1


@gtx.field_operator(backend="gpu")
def diffuse_implicit(q, kappa, kidx, klast: int, dt: float, dz2: float):
    """One backward-Euler step of d q/dt = d/dz (kappa dq/dz).

    Interior rows: -r*kappa q_{k-1} + (1 + 2 r kappa) q_k - r*kappa q_{k+1}
    with r = dt/dz^2; zero-flux boundaries drop the out-of-domain stroke.
    """
    r = dt / dz2
    lower = where(kidx == 0, 0.0, -r * kappa)
    upper = where(kidx == klast, 0.0, -r * kappa)
    diag = 1.0 - lower - upper
    cp, dp = thomas_forward(lower, diag, upper, q)
    return thomas_backward(cp, dp)


def reference_solve(q, kappa, dt, dz2):
    """Dense NumPy oracle: assemble and solve each column's tridiagonal."""
    ni, nj, nk = q.shape
    r = dt / dz2
    out = np.empty_like(q)
    for i in range(ni):
        for j in range(nj):
            m = np.zeros((nk, nk))
            for k in range(nk):
                lo = 0.0 if k == 0 else -r * kappa[i, j, k]
                up = 0.0 if k == nk - 1 else -r * kappa[i, j, k]
                m[k, k] = 1.0 - lo - up
                if k > 0:
                    m[k, k - 1] = lo
                if k < nk - 1:
                    m[k, k + 1] = up
            out[i, j] = np.linalg.solve(m, q[i, j])
    return out


def main() -> None:
    rng = np.random.default_rng(0)
    ni, nj, nk = 16, 16, 24
    q0 = rng.random((ni, nj, nk))
    kappa = 0.5 + 0.5 * rng.random((ni, nj, nk))
    dt, dz2 = 0.1, 1.0

    q = gtx.as_field([IDim, JDim, KDim], q0)
    kf = gtx.as_field([IDim, JDim, KDim], kappa)
    kidx = gtx.as_field([KDim], np.arange(nk, dtype=np.int32))
    out = gtx.zeros({IDim: ni, JDim: nj, KDim: nk})

    diffuse_implicit(q, kf, kidx, nk - 1, dt, dz2, out=out)

    expected = reference_solve(q0, kappa, dt, dz2)
    err = float(np.abs(np.asarray(out.ndarray) - expected).max())
    var = next(
        (v for v in diffuse_implicit._bridge_cache.values() if v is not None), None
    )
    kernel = var.backend.last_kernel if var else "embedded"
    print(f"implicit vertical diffusion: max |err| = {err:.2e} (kernel: {kernel})")
    assert err < 1e-10


if __name__ == "__main__":
    main()
