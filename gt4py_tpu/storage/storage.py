"""Device-resident storage for stencil fields.

Counterpart of the reference storage layer
(/root/reference/src/gt4py/storage/): the reference allocates host/GPU
buffers with backend-specific strides/alignment so the compute-domain origin
sits on an alignment boundary (allocators.py:68,149; cartesian/interface.py:40).
Here physical layout belongs to XLA; what remains semantically meaningful is:

- device residency (device memory via JAX),
- the ``aligned_index`` ↦ *default origin* convention: the index most often
  used as the compute-domain origin, exported through ``__gt_origin__``
  exactly like reference storages,
- dimension annotations (``__gt_dims__``).

Because JAX arrays are immutable, stencils cannot mutate a raw array in
place; :class:`Storage` provides the mutable identity — the stencil runtime
rebinds ``.array`` after each call, so user code keeps reference-style
in-place semantics (``stencil(a, b); use a``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np


class Storage:
    """Mutable ndarray-like wrapper around a ``jax.Array``."""

    __slots__ = ("_array", "_shape", "_dtype", "aligned_index", "dimensions")

    def __init__(
        self,
        array: Any,
        *,
        aligned_index: Optional[Sequence[int]] = None,
        dimensions: Optional[Sequence[str]] = None,
    ):
        self._array = array
        self._shape = tuple(array.shape)
        self._dtype = np.dtype(array.dtype)
        self.aligned_index = (
            tuple(int(i) for i in aligned_index) if aligned_index is not None else None
        )
        self.dimensions = tuple(dimensions) if dimensions is not None else None

    @property
    def array(self) -> Any:
        return self._array

    @array.setter
    def array(self, value: Any) -> None:
        self._array = value
        self._shape = tuple(value.shape)
        self._dtype = np.dtype(value.dtype)

    # -- gt4py interface (reference _core/definitions.py:363-376) -----------

    @property
    def __gt_origin__(self) -> tuple[int, ...]:
        return self.aligned_index or (0,) * len(self._shape)

    @property
    def __gt_dims__(self) -> Optional[tuple[str, ...]]:
        return self.dimensions

    # -- ndarray-like interface --------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._shape))

    def __len__(self) -> int:
        return self._shape[0]

    def __array__(self, dtype=None) -> np.ndarray:
        out = np.asarray(self.array)
        return out.astype(dtype) if dtype is not None else out

    def asnumpy(self) -> np.ndarray:
        return np.asarray(self.array)

    def __getitem__(self, idx) -> Any:
        return np.asarray(self.array)[idx]

    def __setitem__(self, idx, value) -> None:
        import jax.numpy as jnp

        self.array = jnp.asarray(self.array).at[idx].set(value)

    def copy(self) -> "Storage":
        import jax.numpy as jnp

        return Storage(
            jnp.array(self.array),
            aligned_index=self.aligned_index,
            dimensions=self.dimensions,
        )

    def block_until_ready(self) -> "Storage":
        if hasattr(self.array, "block_until_ready"):
            self.array.block_until_ready()
        return self

    def __repr__(self) -> str:
        return (
            f"Storage(shape={self.shape}, dtype={self.dtype}, "
            f"aligned_index={self.aligned_index})"
        )

    # Comparisons delegate to NumPy semantics for test convenience.
    def __eq__(self, other):
        return np.asarray(self) == np.asarray(other)

    def __ne__(self, other):
        return np.asarray(self) != np.asarray(other)

    def __hash__(self):
        return id(self)
