"""Benchmark: the canonical stencils on one GPU, through the public API.

Prints ONE JSON line with the device it ran on, the card's name and power
limit, and per workload the median time of one call and of one step of a
10-step ``chain``, each after a warm-up call, each ending in
``block_until_ready``; compile time is set-up and reported apart. A phase
that fails ends the run with a nonzero exit, and there is no CPU fallback:
without a GPU the run stops.

Workloads (one card's share of a regional dynamical core, 512x512x80):
horizontal diffusion, vertical advection and the tridiagonal solver in
float64 and float32 on the ``gpu`` and ``jax`` backends, and a large
device copy, the practical bandwidth ceiling hdiff is read against.
``chip_smoke.py`` runs the same cases, checks them against the ``numpy``
backend and adds the field-view path.

Run:  python bench.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

#: Published peaks per JAX ``device_kind``: NVIDIA H100 Tensor Core GPU data
#: sheet, SXM5 part, dense rates at the 700 W power limit. A card below
#: that limit cannot hold its top clock; the limit is printed beside every
#: number.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp64_flop_per_s": 34e12,
        "fp32_flop_per_s": 67e12,
        "source": "NVIDIA H100 data sheet, SXM5, dense",
    },
}

#: one card's share of a regional dynamical core: 512x512 columns of 80
#: levels (168 MB per float64 field, more than 3x the 50 MB L2)
DOMAIN = (512, 512, 80)
CHAIN_STEPS = 10


def device_peaks(device_kind: str) -> dict:
    """Peak rates of a device kind; a kind not in :data:`PEAKS` is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            f"bench.PEAKS with its source"
        ) from None


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them (read
    by a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu():
    """The first GPU; stops the run when JAX found none."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {jax.default_backend()!r}")
    return jax.devices()[0]


def device_tag() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def median_seconds(fn, runs: int = 7) -> float:
    """Median wall time of ``fn()``, which must block until the device is
    done; the caller warms it up first."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# --- the three dycore stencils -----------------------------------------------

PRECISIONS = {"f64": np.float64, "f32": np.float32}


def cartesian_case(name: str, precision: str, seed: int = 0) -> dict:
    """Definition, build options, host inputs and call arguments of one
    dycore stencil (tests/cartesian_tests/stencil_defs.py) at :data:`DOMAIN`.

    Inputs are made from ``seed``. The solvers get well-conditioned systems
    as a dycore has them: tridiag diagonally dominant, vadv with vertical
    winds small against ``dtr_stage``."""
    from tests.cartesian_tests import stencil_defs as defs

    dt = PRECISIONS[precision]
    rng = np.random.default_rng(seed)
    domain = DOMAIN
    ni, nj, nk = domain
    build = {
        "dtypes": {"float_t": dt},
        "literal_float_precision": 64 if precision == "f64" else 32,
    }

    def rand(shape, lo=0.0, scale=1.0):
        return (lo + scale * rng.random(shape)).astype(dt)

    if name == "hdiff":
        shape = (ni + 4, nj + 4, nk)
        arrays = {
            "in_field": rand(shape),
            "out_field": np.zeros(shape, dt),
            "coeff": rand(shape, 0.0, 0.05),
        }
        return dict(
            definition=defs.horizontal_diffusion_generic, externals={}, build=build,
            arrays=arrays, scalars={}, call={"origin": (2, 2, 0), "domain": domain},
            swap={"in_field": "out_field", "out_field": "in_field"},
            outputs=("out_field",), bytes_per_point=3 * np.dtype(dt).itemsize,
        )
    if name == "vadv":
        shape = (ni + 1, nj, nk)
        arrays = {
            "utens_stage": rand(shape),
            "u_stage": rand(shape),
            "wcon": rand(shape, 0.0, 0.1),
            "u_pos": rand(shape),
            "utens": rand(shape),
        }
        return dict(
            definition=defs.vertical_advection_dycore_generic,
            externals=defs.VADV_EXTERNALS, build=build, arrays=arrays,
            scalars={"dtr_stage": dt(3.0 / 20.0)},
            call={"origin": (0, 0, 0), "domain": domain}, swap={},
            outputs=("utens_stage",), bytes_per_point=6 * np.dtype(dt).itemsize,
        )
    if name == "tridiag":
        shape = (ni, nj, nk)
        arrays = {
            "inf": rand(shape, -0.35, 0.1),
            "diag": rand(shape, 2.0, 1.0),
            "sup": rand(shape, -0.35, 0.1),
            "rhs": rand(shape),
            "out": np.zeros(shape, dt),
        }
        return dict(
            definition=defs.tridiagonal_solver_generic, externals={}, build=build,
            arrays=arrays, scalars={}, call={"origin": (0, 0, 0), "domain": domain},
            # the solution is the next step's right-hand side (implicit steps)
            swap={"rhs": "out", "out": "rhs"},
            outputs=("out", "rhs", "sup"), bytes_per_point=7 * np.dtype(dt).itemsize,
        )
    raise ValueError(name)


def build_stencil(case: dict, backend: str, tag: str = ""):
    from gt4py_tpu.cartesian import gtscript

    name = f"{case['definition'].__name__}_{case['build']['dtypes']['float_t'].__name__}"
    return gtscript.stencil(
        backend=backend, definition=case["definition"], externals=case["externals"],
        name=f"{name}_{backend}{tag}", **case["build"],
    )


def storages(case: dict, backend: str) -> dict:
    from gt4py_tpu import storage

    return {n: storage.from_array(a, backend=backend) for n, a in case["arrays"].items()}


def block(stores: dict) -> None:
    import jax

    jax.block_until_ready([s.array for s in stores.values()])


def call_and_chain_seconds(st, stores: dict, case: dict) -> tuple[float, float]:
    """Median seconds of one call (7 runs) and of one step of a
    ``CHAIN_STEPS`` chain (5 chains); both are warmed up by the caller."""
    kw = {**case["scalars"], **case["call"]}
    call = median_seconds(lambda: (st(**stores, **kw), block(stores)))
    chain = median_seconds(
        lambda: (st.chain(CHAIN_STEPS, **stores, swap=case["swap"], **kw), block(stores)),
        runs=5,
    )
    return call, chain / CHAIN_STEPS


def time_cartesian(case: dict, backend: str) -> dict:
    """Compile, call and chain times of one case on one backend."""
    st = build_stencil(case, backend)
    stores = storages(case, backend)
    kw = {**case["scalars"], **case["call"]}
    info: dict = {}
    t0 = time.perf_counter()
    st(**stores, exec_info=info, **kw)
    st.chain(CHAIN_STEPS, **stores, swap=case["swap"], **kw)
    block(stores)
    compile_s = time.perf_counter() - t0
    call, step = call_and_chain_seconds(st, stores, case)
    return {
        "kernel": info["kernel"],
        "compile_s": round(compile_s, 3),
        "call_ms": call * 1e3,
        "chain_step_ms": step * 1e3,
    }


def copy_ceiling_bytes_per_s(n_bytes: int = 1 << 30) -> float:
    """Read+write rate of a large on-device copy (XLA's own loop kernel)."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros(n_bytes // 8, jnp.float64)
    f = jax.jit(lambda a: a + 1.0)
    f(x).block_until_ready()
    t = median_seconds(lambda: f(x).block_until_ready(), runs=9)
    return 2 * n_bytes / t


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = require_gpu()
    peaks = device_peaks(dev.device_kind)
    from gt4py_tpu.cartesian.caching import enable_persistent_cache

    enable_persistent_cache()
    points = int(np.prod(DOMAIN))
    results: dict = {"domain": list(DOMAIN), "card": card()}
    results["copy_ceiling_GB_s"] = copy_ceiling_bytes_per_s() / 1e9
    for name in ("hdiff", "vadv", "tridiag"):
        for precision in PRECISIONS:
            case = cartesian_case(name, precision)
            for backend in ("gpu", "jax"):
                r = time_cartesian(case, backend)
                key = f"{name}_{precision}_{backend}"
                results[key] = r
                moved = case["bytes_per_point"] * points
                r["GB_s"] = moved / (r["call_ms"] * 1e-3) / 1e9
                r["hbm_peak_share"] = r["GB_s"] * 1e9 / peaks["hbm_bytes_per_s"]
                print(f"[bench] {key}: {r}", file=sys.stderr)
    hd = results["hdiff_f32_gpu"]
    print(json.dumps({
        "metric": "hdiff_f32_gpu_gridpoints_per_s",
        "value": points / (hd["call_ms"] * 1e-3),
        "unit": "gridpoints/s",
        "device": device_tag(),
        "peaks_source": peaks["source"],
        "results": results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
