from gt4py_tpu.cartesian.backend.base import (  # noqa: F401
    Backend,
    REGISTRY,
    from_name,
    register,
)

# Import concrete backends so they self-register (reference pattern:
# backend/__init__.py imports + Backend.register, base.py:129-147).
from gt4py_tpu.cartesian.backend import c_backend  # noqa: F401,E402
from gt4py_tpu.cartesian.backend import debug_backend  # noqa: F401,E402
from gt4py_tpu.cartesian.backend import jax_backend  # noqa: F401,E402
from gt4py_tpu.cartesian.backend import numpy_backend  # noqa: F401,E402
