"""gt4py_tpu — stencil computation framework on JAX, run on NVIDIA GPUs.

A from-scratch framework with the capabilities of GridTools/gt4py
(reference mounted at /root/reference): the GTScript cartesian DSL and the
declarative field-view DSL, compiled to JAX/XLA (plus one Pallas-Triton
kernel for vertical sweeps) instead of generated C++/CUDA. See
ARCHITECTURE.md for the layer map and the mapping from every reference
component to its equivalent here.
"""

import jax as _jax

# GTScript semantics require real 64-bit dtypes (the DSL dtype model follows
# NumPy; the reference's JAX field implementation does the same,
# /root/reference/src/gt4py/next/embedded/nd_array_field.py:1060). This only
# widens the *allowed* dtype set — float32/bfloat16 arrays stay narrow.
_jax.config.update("jax_enable_x64", True)

from gt4py_tpu import cartesian, config, eve, storage  # noqa: F401,E402

__version__ = "0.4.0"
