"""Field buffer allocators.

Counterpart of the reference's ``gt4py.next.custom_layout_allocators``
(/root/reference/src/gt4py/next/custom_layout_allocators.py:35,191,236):
an allocator protocol deciding device placement and layout for new field
buffers. Physical layout on the device belongs to XLA; what an allocator
decides is the *device* (CPU host vs GPU memory, or a specific device in a
multi-process setup) and the sharding for distributed fields.
"""

from __future__ import annotations

from typing import Any, Optional, Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class FieldBufferAllocatorProtocol(Protocol):
    """Reference FieldBufferAllocatorProtocol (custom_layout_allocators.py:35)."""

    def allocate(self, shape: Sequence[int], dtype: Any) -> Any: ...


class CPUFieldBufferAllocator:
    """Host-resident buffers; horizontal-first layout is NumPy row-major
    (reference StandardCPUFieldBufferAllocator, :191). Uses the native
    aligned allocator (csrc/fastpath.c) when built."""

    def __init__(self, alignment: int = 64):
        self.alignment = alignment

    def allocate(self, shape: Sequence[int], dtype: Any) -> np.ndarray:
        from gt4py_tpu.core.native import aligned_empty

        arr = aligned_empty(tuple(shape), np.dtype(dtype), alignment=self.alignment)
        arr[...] = 0
        return arr


class DeviceFieldBufferAllocator:
    """Device-resident jax.Array buffers (role of the reference's CUDA
    allocator, :236). Optionally places on a specific device or with a
    NamedSharding for distributed fields."""

    def __init__(self, device: Optional[Any] = None, sharding: Optional[Any] = None):
        self.device = device
        self.sharding = sharding

    def allocate(self, shape: Sequence[int], dtype: Any):
        import jax
        import jax.numpy as jnp

        buf = jnp.zeros(tuple(shape), dtype=np.dtype(dtype))
        target = self.sharding or self.device
        if target is not None:
            buf = jax.device_put(buf, target)
        return buf


def device_allocator(device: Any = None, sharding: Any = None):
    """Allocator for a device spec: None -> JAX's default device (the GPU);
    'cpu' -> host buffers."""
    if device == "cpu":
        return CPUFieldBufferAllocator()
    return DeviceFieldBufferAllocator(
        device=None if device in (None, "gpu") else device, sharding=sharding
    )


DEFAULT_ALLOCATOR = DeviceFieldBufferAllocator()
