"""Layout descriptors and per-backend layout registry.

Counterpart of the reference's ``gt4py.storage.cartesian.layout``
(/root/reference/src/gt4py/storage/cartesian/layout.py:21,28,71) and
``layout_registry.py:13,23``: each backend registers a ``LayoutInfo``
describing where its storages live and how the axes map to the physical
order; ``storage.empty(..., backend=...)`` consults the registry.

Physical layout on the device belongs to XLA, so ``layout_map`` expresses
the logical-to-minor order a backend's storages use: every built-in backend
keeps the public (I, J, K) order, K minor. ``alignment`` keeps the
reference's aligned-origin convention for host staging buffers (allocated
natively via csrc/fastpath.c when built).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class LayoutInfo:
    """Reference LayoutInfo TypedDict (layout.py:21) as a frozen dataclass."""

    alignment: int  # bytes; aligned-index placement for host staging
    device: str  # "cpu" | "gpu"
    layout_map: tuple[int, ...]  # per logical axis (I, J, K): physical order rank
    is_optimal_layout: bool = True

    def physical_order(self, dimensions: Sequence[str] = ("I", "J", "K")) -> tuple[int, ...]:
        """Axis permutation from logical to physical (minor last)."""
        order = sorted(range(len(self.layout_map)), key=lambda i: self.layout_map[i])
        return tuple(order)


REGISTRY: dict[str, LayoutInfo] = {}


def register(backend_name: str, info: LayoutInfo) -> None:
    """Register a backend's layout (reference layout_registry.py:23;
    backends self-register at import, backend/base.py:147)."""
    REGISTRY[backend_name] = info


def from_name(backend_name: str) -> Optional[LayoutInfo]:
    return REGISTRY.get(backend_name)


def is_gpu_backend(backend_name: str) -> bool:
    info = REGISTRY.get(backend_name)
    return info is not None and info.device == "gpu"


# Built-in backends; "jax" runs wherever JAX runs, a GPU in deployment.
register("debug", LayoutInfo(alignment=1, device="cpu", layout_map=(0, 1, 2)))
register("numpy", LayoutInfo(alignment=64, device="cpu", layout_map=(0, 1, 2)))
register("cpu:c", LayoutInfo(alignment=64, device="cpu", layout_map=(0, 1, 2)))
register("jax", LayoutInfo(alignment=128, device="gpu", layout_map=(0, 1, 2)))
register("gpu", LayoutInfo(alignment=128, device="gpu", layout_map=(0, 1, 2)))
