"""Array-namespace utilities shared across execution paths.

Counterpart of the reference's ``gt4py._core.ndarray_utils``
(/root/reference/src/gt4py/_core/ndarray_utils.py): resolve the array
namespace for a given array object, convert between host and device
representations, and provide namespace-generic slicing helpers. There
are two namespaces — NumPy (eager oracles) and jax.numpy
(traced/compiled).

``gt4py_tpu.cartesian.backend.evaluator._NamespaceOps`` builds on these
helpers for the stencil evaluator's windowed access patterns, and
``gt4py_tpu.next.embedded._xp`` is the field-view entry point to the same
dispatch rule.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np


def array_namespace(arr: Any):
    """The compute namespace module of ``arr``: ``numpy`` for host arrays
    (and scalars), ``jax.numpy`` for traced/device arrays (reference
    array_utils.get_array_ns)."""
    if isinstance(arr, (np.ndarray, np.generic, int, float, bool)):
        return np
    import jax.numpy as jnp

    return jnp


def asnumpy(arr: Any) -> np.ndarray:
    """Host copy of any supported array (device transfers included)."""
    return np.asarray(arr)


def asarray(arr: Any, *, like: Any = None):
    """Convert ``arr`` into the namespace of ``like`` (or keep its own)."""
    xp = array_namespace(like if like is not None else arr)
    return xp.asarray(arr)


def is_jax_array(arr: Any) -> bool:
    import jax

    return isinstance(arr, jax.Array)


def slice_nd(arr, starts, sizes, *, xp=None):
    """N-d window slice with static or traced start indices (traced starts
    require the jax namespace — lax.dynamic_slice)."""
    if all(isinstance(s, (int, np.integer)) for s in starts):
        idx = tuple(slice(int(s), int(s) + int(z)) for s, z in zip(starts, sizes))
        idx = idx + (slice(None),) * (arr.ndim - len(starts))
        return arr[idx]
    import jax.lax as lax

    full_starts = list(starts) + [0] * (arr.ndim - len(starts))
    full_sizes = list(sizes) + list(arr.shape[len(starts):])
    return lax.dynamic_slice(arr, full_starts, full_sizes)


def update_nd(arr, starts, value, *, xp=None):
    """Write a window into ``arr`` (in place for NumPy, functional for
    jax; traced starts use lax.dynamic_update_slice)."""
    xp = xp if xp is not None else array_namespace(arr)
    if xp is np:
        idx = tuple(
            slice(int(s), int(s) + int(z)) for s, z in zip(starts, value.shape)
        )
        idx = idx + (slice(None),) * (arr.ndim - len(starts))
        arr[idx] = value
        return arr
    if all(isinstance(s, (int, np.integer)) for s in starts):
        idx = tuple(slice(int(s), int(s) + z) for s, z in zip(starts, value.shape))
        return arr.at[idx].set(value)
    import jax.lax as lax

    full_starts = list(starts) + [0] * (arr.ndim - len(starts))
    return lax.dynamic_update_slice(arr, value, full_starts)


def broadcast_iota(xp, shape, axis, dtype=np.int32):
    """Index grid along ``axis`` broadcast over ``shape`` (lax iota on the
    jax namespace — XLA folds it; arange+broadcast on NumPy)."""
    if xp is np:
        n = shape[axis]
        view = np.arange(n, dtype=dtype).reshape(
            (1,) * axis + (n,) + (1,) * (len(shape) - axis - 1)
        )
        return np.broadcast_to(view, shape)
    from jax import lax

    return lax.broadcasted_iota(dtype, shape, axis)
