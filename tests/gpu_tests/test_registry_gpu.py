"""Hardware tier: the whole stencil registry on the GPU.

Every registry stencil runs on the card through the ``gpu`` backend, in
float64 and in float32 (the GTIR narrowed to 32 bits), and must match the
``numpy`` oracle on the same GTIR. The FORWARD/BACKWARD solvers must be
served by the K-sweep kernel compiled through Triton; a silent fall back
to XLA fails here.

Run:  GT4PY_TEST_PLATFORM=gpu python -m pytest tests/gpu_tests -m gpu -q
(``python chip_smoke.py`` runs this tier in its own process.)
"""

import numpy as np
import pytest

from tests.cartesian_tests import stencil_defs as defs
from tests.cartesian_tests.test_ksweep_triton import SEQUENTIAL, _case

pytestmark = pytest.mark.gpu

#: stencils whose semantics depend on 64-bit precision: narrowing changes
#: termination or range, not just rounding
NOT_NARROWABLE = {
    "newton_sqrt_while",  # 1e-10 convergence tolerance unreachable in f32
    "dtype_zoo",  # int64-range literals by design
}
CASES = [(n, "f64") for n in sorted(defs.REGISTRY)] + [
    (n, "f32") for n in sorted(defs.REGISTRY) if n not in NOT_NARROWABLE
]

#: Tolerances against the numpy oracle. The GPU contracts multiply-adds to
#: FMA and orders operations differently; the K recurrences carry that
#: through every level. The registry's random systems are not diagonally
#: dominant, so in float32 the division chains of the two solvers amplify
#: a last-bit difference up to ~4e-3 relative (the Pallas interpreter on
#: the CPU shows the same spread against numpy).
TOLERANCE = {"f64": (1e-10, 1e-12), "f32": (1e-5, 1e-6)}
F32_SOLVER_TOLERANCE = (5e-3, 5e-4)
F32_SOLVERS = {"tridiagonal_solver", "vertical_advection_dycore"}


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("no GPU (set GT4PY_TEST_PLATFORM=gpu to lift the CPU pin)")
    from gt4py_tpu.cartesian.caching import enable_persistent_cache

    enable_persistent_cache()
    return jax.devices()[0]


@pytest.mark.parametrize("name,precision", CASES)
def test_registry_stencil_on_gpu(gpu, name, precision):
    import jax.numpy as jnp

    from gt4py_tpu.cartesian.backend.base import REGISTRY as BACKENDS

    # non-power-of-two IJ, so the kernel's edge tiles are masked
    domain = (37, 33, max(16, defs.REGISTRY[name]["min_k"]))
    analyzed, arrays, scalars, origins = _case(name, precision, domain)
    backend = BACKENDS["gpu"](analyzed, {})
    oracle = BACKENDS["numpy"](analyzed, {})
    ref = oracle.run({k: v.copy() for k, v in arrays.items()}, dict(scalars), domain, origins)
    got = backend.run(
        {k: jnp.asarray(v) for k, v in arrays.items()}, dict(scalars), domain, origins
    )
    if name in SEQUENTIAL:
        assert backend.last_kernel == "triton"
    else:
        assert backend.last_kernel in ("xla", "triton")
    rtol, atol = TOLERANCE[precision]
    if precision == "f32" and name in F32_SOLVERS:
        rtol, atol = F32_SOLVER_TOLERANCE
    for fname, expected in ref.items():
        np.testing.assert_allclose(
            np.asarray(got[fname]), np.asarray(expected), rtol=rtol, atol=atol,
            err_msg=f"{name}/{fname} ({precision}, kernel={backend.last_kernel})",
        )
