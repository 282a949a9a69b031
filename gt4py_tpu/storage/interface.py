"""Storage allocation interface.

API parity with the reference's
``gt4py.storage.cartesian.interface`` (empty/zeros/ones/full/from_array,
/root/reference/src/gt4py/storage/cartesian/interface.py:40-264): same
signatures (``shape, dtype, *, backend, aligned_index, dimensions``); the
returned object is a :class:`~gt4py_tpu.storage.storage.Storage` holding a
device-resident JAX array instead of a strided host buffer — layout and
alignment on the device are XLA's responsibility.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from gt4py_tpu.storage.storage import Storage

_KNOWN_BACKENDS = {"debug", "numpy", "cpu:c", "jax", "gpu"}


def _validate(shape, aligned_index, dimensions, backend) -> None:
    if backend not in _KNOWN_BACKENDS:
        raise ValueError(
            f"Unknown backend '{backend}' (expected one of {sorted(_KNOWN_BACKENDS)})"
        )
    if aligned_index is not None:
        if len(aligned_index) != len(shape):
            raise ValueError(
                f"'aligned_index' ({aligned_index}) does not match shape {shape}"
            )
        if any(i < 0 for i in aligned_index):
            raise ValueError(f"'aligned_index' must be non-negative, got {aligned_index}")
    if dimensions is not None and len(dimensions) != len(shape):
        raise ValueError(f"'dimensions' ({dimensions}) does not match shape {shape}")


def empty(
    shape: Sequence[int],
    dtype: Any = np.float64,
    *,
    backend: str = "jax",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
) -> Storage:
    """Allocate an uninitialized-value storage (zero-filled: XLA has no
    uninitialized allocation).

    With ``GT4PY_DEBUG_POISON_EMPTY=1`` the fill becomes NaN (floats) /
    the dtype's max (ints) instead: reference test suites rely on
    "uninitialized garbage stays untouched" to detect out-of-domain
    writes and unread cells — the poison fill restores that signal, which
    a silent zero fill destroys."""
    import os

    if os.environ.get("GT4PY_DEBUG_POISON_EMPTY", "0") not in ("0", "", "false"):
        dt = np.dtype(dtype)
        if dt.kind == "f" or dt.name in ("bfloat16",):
            fill: Any = float("nan")
        elif dt.kind in ("i", "u"):
            fill = np.iinfo(dt).max
        else:
            fill = True
        return full(
            shape, fill, dtype,
            backend=backend, aligned_index=aligned_index, dimensions=dimensions,
        )
    return zeros(
        shape, dtype, backend=backend, aligned_index=aligned_index, dimensions=dimensions
    )


def zeros(
    shape: Sequence[int],
    dtype: Any = np.float64,
    *,
    backend: str = "jax",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
) -> Storage:
    import jax.numpy as jnp

    shape = tuple(int(s) for s in shape)
    _validate(shape, aligned_index, dimensions, backend)
    return Storage(
        jnp.zeros(shape, dtype=np.dtype(dtype)),
        aligned_index=aligned_index,
        dimensions=dimensions,
    )


def ones(
    shape: Sequence[int],
    dtype: Any = np.float64,
    *,
    backend: str = "jax",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
) -> Storage:
    import jax.numpy as jnp

    shape = tuple(int(s) for s in shape)
    _validate(shape, aligned_index, dimensions, backend)
    return Storage(
        jnp.ones(shape, dtype=np.dtype(dtype)),
        aligned_index=aligned_index,
        dimensions=dimensions,
    )


def full(
    shape: Sequence[int],
    fill_value: Any,
    dtype: Any = np.float64,
    *,
    backend: str = "jax",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
) -> Storage:
    import jax.numpy as jnp

    shape = tuple(int(s) for s in shape)
    _validate(shape, aligned_index, dimensions, backend)
    return Storage(
        jnp.full(shape, fill_value, dtype=np.dtype(dtype)),
        aligned_index=aligned_index,
        dimensions=dimensions,
    )


def from_array(
    data: Any,
    dtype: Any = None,
    *,
    backend: str = "jax",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
) -> Storage:
    import jax.numpy as jnp

    array = np.asarray(data)
    if dtype is not None:
        array = array.astype(np.dtype(dtype))
    _validate(array.shape, aligned_index, dimensions, backend)
    return Storage(
        jnp.asarray(array), aligned_index=aligned_index, dimensions=dimensions
    )
