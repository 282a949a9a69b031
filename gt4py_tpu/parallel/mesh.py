"""Device-mesh management for multi-device stencil execution.

This subsystem is NEW functionality relative to the reference: gt4py is
single-process and delegates distribution to consumers (GHEX/mpi4py in the
GridTools ecosystem — verified absent in the reference by grep, SURVEY.md
§2.6). The design here decomposes the horizontal IJ domain over a 2-D
``jax.sharding.Mesh``; K stays on one device (sequential sweeps are a
per-column loop). The GPUs of one host are joined all to all by NVLink, so
the mesh follows the decomposition alone: devices in the order JAX lists
them, on the most square grid that holds them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


class CartesianMesh:
    """2-D (x, y) device mesh for IJ domain decomposition."""

    def __init__(
        self,
        devices: Optional[Sequence] = None,
        shape: Optional[tuple[int, int]] = None,
    ):
        import numpy as np

        devices = list(jax.devices() if devices is None else devices)
        n = len(devices)
        if shape is None:
            shape = _factor2(n)
        if shape[0] * shape[1] != n:
            raise ValueError(f"Mesh shape {shape} does not match {n} devices")
        self.shape = tuple(shape)
        #: device grid as laid out on the mesh (row-major (x, y))
        self.device_grid = np.asarray(devices).reshape(self.shape)
        self.mesh = Mesh(self.device_grid, axis_names=("x", "y"))

    @property
    def nx(self) -> int:
        return self.shape[0]

    @property
    def ny(self) -> int:
        return self.shape[1]

    def sharding(self, spec: PartitionSpec = PartitionSpec("x", "y", None)) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    def shard_ij(self, array):
        """Place a global (I, J, K) array sharded over the mesh."""
        return jax.device_put(array, self.sharding())


def _factor2(n: int) -> tuple[int, int]:
    """Most-square factorization of n (the least halo surface per shard)."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best
