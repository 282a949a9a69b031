"""Isentropic-coordinate diagnostics (reference
demo_isentropic_diagnostics.ipynb): one stencil chains a FORWARD
hydrostatic pressure integration, a PARALLEL Exner function, and BACKWARD
Montgomery-potential / isentrope-height integrations — the multi-loop
sequential composition the K-sweep kernel serves on the ``gpu`` backend.

Run: python examples/isentropic_diagnostics.py [backend]
"""

import sys

import numpy as np

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript

RD = 287.05       # gas constant of dry air [J kg^-1 K^-1]
G = 9.81          # gravity [m s^-2]
P_REF = 1.0e5     # reference pressure [Pa]
CP = 1004.0       # specific heat at constant pressure [J kg^-1 K^-1]
BV = 0.01         # Brunt-Vaisala frequency [s^-1]

Field = gtscript.Field[np.float64]


def make_diagnostics(backend: str):
    externals = {"rd": RD, "g": G, "p_ref": P_REF, "cp": CP}

    @gtscript.stencil(backend=backend, externals=externals)
    def diagnostic_step(
        theta: Field,
        hs: Field,
        s: Field,
        p: Field,
        exn: Field,
        mtg: Field,
        h: Field,
        *,
        dtheta: float,
        pt: float,
    ):
        from __externals__ import cp, g, p_ref, rd

        # hydrostatic pressure: integrate downward through the isentropes
        with gtscript.computation("FORWARD"):
            with gtscript.interval(0, 1):
                p = pt
            with gtscript.interval(1, None):
                p = p[0, 0, -1] + g * dtheta * s[0, 0, -1]

        # Exner function
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            exn = cp * (p[0, 0, 0] / p_ref) ** (rd / cp)

        # Montgomery potential: integrate upward from the surface level
        with gtscript.computation("BACKWARD"):
            with gtscript.interval(-2, -1):
                mtg = (
                    theta[0, 0, 1] * exn[0, 0, 1]
                    + g * hs[0, 0, 1]
                    + 0.5 * dtheta * exn[0, 0, 1]
                )
            with gtscript.interval(0, -2):
                mtg = mtg[0, 0, 1] + dtheta * exn[0, 0, 1]

        # geometric height of the isentropes
        with gtscript.computation("BACKWARD"):
            with gtscript.interval(-1, None):
                h = hs[0, 0, 0]
            with gtscript.interval(0, -1):
                h = h[0, 0, 1] - rd * (
                    theta[0, 0, 0] * exn[0, 0, 0] + theta[0, 0, 1] * exn[0, 0, 1]
                ) * (p[0, 0, 0] - p[0, 0, 1]) / (cp * g * (p[0, 0, 0] + p[0, 0, 1]))

    return diagnostic_step


def reference_diagnostics(theta, hs, s, dtheta, pt):
    """NumPy oracle of the same integrations."""
    nx, ny, nz1 = theta.shape
    p = np.zeros_like(theta)
    p[:, :, 0] = pt
    for k in range(1, nz1):
        p[:, :, k] = p[:, :, k - 1] + G * dtheta * s[:, :, k - 1]
    exn = CP * (p / P_REF) ** (RD / CP)
    mtg = np.zeros_like(theta)
    mtg[:, :, nz1 - 2] = (
        theta[:, :, nz1 - 1] * exn[:, :, nz1 - 1]
        + G * hs[:, :, nz1 - 1]
        + 0.5 * dtheta * exn[:, :, nz1 - 1]
    )
    for k in range(nz1 - 3, -1, -1):
        mtg[:, :, k] = mtg[:, :, k + 1] + dtheta * exn[:, :, k + 1]
    h = np.zeros_like(theta)
    h[:, :, -1] = hs[:, :, -1]
    for k in range(nz1 - 2, -1, -1):
        h[:, :, k] = h[:, :, k + 1] - RD * (
            theta[:, :, k] * exn[:, :, k] + theta[:, :, k + 1] * exn[:, :, k + 1]
        ) * (p[:, :, k] - p[:, :, k + 1]) / (CP * G * (p[:, :, k] + p[:, :, k + 1]))
    return p, exn, mtg, h


def build_initial_state(nx, ny, nz):
    """Bell-shaped mountain under a uniformly stratified atmosphere."""
    theta1d = np.linspace(340.0, 280.0, nz + 1)
    theta = np.tile(theta1d, (nx, ny, 1))
    dtheta = 60.0 / nz

    x1d = np.linspace(-150e3, 150e3, nx)
    y1d = np.linspace(-150e3, 150e3, ny)
    x, y = np.meshgrid(x1d, y1d, indexing="ij")
    hs = np.zeros((nx, ny, nz + 1))
    hs[:, :, -1] = 1000.0 * np.exp(-((x / 50e3) ** 2) - (y / 50e3) ** 2)

    # Exner/pressure profile for the isentropic density diagnostic
    exn = np.zeros((nx, ny, nz + 1))
    exn[:, :, -1] = CP
    for k in range(nz - 1, -1, -1):
        exn[:, :, k] = exn[:, :, k + 1] - dtheta * G**2 / (BV**2 * theta[:, :, k] ** 2)
    p = P_REF * (exn / CP) ** (CP / RD)
    s = np.zeros((nx, ny, nz + 1))
    s[:, :, :-1] = -(p[:, :, :-1] - p[:, :, 1:]) / (G * dtheta)
    return theta, hs, s, dtheta, float(p[0, 0, 0])


def run(backend: str = "jax", nx: int = 32, ny: int = 32, nz: int = 64, verbose=True):
    theta_np, hs_np, s_np, dtheta, pt = build_initial_state(nx, ny, nz)
    step = make_diagnostics(backend)

    arrays = {
        "theta": theta_np, "hs": hs_np, "s": s_np,
        "p": np.zeros_like(theta_np), "exn": np.zeros_like(theta_np),
        "mtg": np.zeros_like(theta_np), "h": np.zeros_like(theta_np),
    }
    stor = {k: storage.from_array(v, backend=backend) for k, v in arrays.items()}
    step(**stor, dtheta=dtheta, pt=pt)

    p_ref, exn_ref, mtg_ref, h_ref = reference_diagnostics(
        theta_np, hs_np, s_np, dtheta, pt
    )
    errs = {
        "p": np.max(np.abs(np.asarray(stor["p"]) - p_ref) / np.abs(p_ref).max()),
        "exn": np.max(np.abs(np.asarray(stor["exn"]) - exn_ref) / np.abs(exn_ref).max()),
        "mtg": np.max(np.abs(np.asarray(stor["mtg"]) - mtg_ref) / np.abs(mtg_ref).max()),
        "h": np.max(np.abs(np.asarray(stor["h"]) - h_ref) / (np.abs(h_ref).max() or 1.0)),
    }
    if verbose:
        print(f"backend={backend} rel errors:", {k: f"{v:.2e}" for k, v in errs.items()})
    return errs, stor


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "jax")
