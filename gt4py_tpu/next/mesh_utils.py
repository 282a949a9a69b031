"""Mesh numbering utilities for the structured-connectivity fast path.

The embedded gather executes a connectivity column as rolls + masked
selects when its ``(target - source) mod n`` diffs form few cyclic-shift
classes (``embedded._shift_plan``), and tolerates a small residual of
irregular rows (hybrid plan).  Whether a REAL mesh qualifies is purely a
property of its *numbering*: a structured mesh scrambled by an arbitrary
vertex permutation pays the full per-row gather rate, while the same mesh
numbered row-major streams.

This module gives users the levers:

- :func:`shift_structure_report` — per-column shift-class diagnostics, so
  a user can see WHY a mesh is (not) on the fast path.
- :func:`spatial_renumbering` — row-major (optionally tiled) numbering
  from element coordinates, the ordering that maximises shift regularity
  for grid-like meshes.
- :class:`Renumbering` — applies a permutation consistently to
  connectivity tables and field data (both sides of every table must be
  relabelled together or the mesh changes meaning).

Reference analog: gt4py has no renumbering utility — meshes arrive
pre-numbered from Atlas/ICON (see the fvm_nabla setup in
``tests/next_tests/.../ffront_tests/test_fvm_nabla.py:64``). Whether the
numbering matters on the GPU, where gathers are cached, is not measured
(ROADMAP Speed 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from gt4py_tpu.next.common import Connectivity, Dimension

__all__ = [
    "Renumbering",
    "periodic_quad_mesh",
    "shift_structure_report",
    "spatial_renumbering",
]


def periodic_quad_mesh(n: int):
    """Periodic ``n x n`` quad mesh in row-major numbering (the FVM-nabla
    benchmark workload; reference mesh family:
    tests/next_tests/.../iterator_tests/test_fvm_nabla.py:64-106 via
    atlas). ``n*n`` vertices; ``2*n*n`` edges, horizontal block first
    (edge ``h(i,j)`` joins ``(i,j)-(i+1,j)``) then vertical (``(i,j)-
    (i,j+1)``), both wrapping periodically. Vectorized — builds the
    million-vertex benchmark meshes in well under a second.

    Returns ``(e2v, v2e, signs)``: ``e2v`` of shape ``(2n², 2)``,
    ``v2e`` of shape ``(n², 4)`` ordered (out-horizontal, in-horizontal,
    out-vertical, in-vertical), ``signs`` the matching (+1, -1, +1, -1)
    orientation weights."""
    nv = n * n
    i, j = np.divmod(np.arange(nv, dtype=np.int64), n)

    def vid(ii, jj):
        return (ii % n) * n + (jj % n)

    e2v = np.empty((2 * nv, 2), dtype=np.int64)
    e2v[:nv, 0] = vid(i, j)
    e2v[:nv, 1] = vid(i + 1, j)
    e2v[nv:, 0] = vid(i, j)
    e2v[nv:, 1] = vid(i, j + 1)

    v2e = np.empty((nv, 4), dtype=np.int64)
    v2e[:, 0] = vid(i, j)
    v2e[:, 1] = vid(i - 1, j)
    v2e[:, 2] = nv + vid(i, j)
    v2e[:, 3] = nv + vid(i, j - 1)
    signs = np.tile(np.asarray([1.0, -1.0, 1.0, -1.0]), (nv, 1))
    return e2v, v2e, signs


def shift_structure_report(
    conn: Connectivity, codomain_size: int, *, own_start: int = 0
) -> list[dict]:
    """Per-column diagnostics of the roll-decomposition eligibility.

    Returns one dict per neighbor column with:

    - ``n_classes``: distinct cyclic-shift classes over valid rows
    - ``residual_frac``: fraction of valid rows OUTSIDE the top classes
      kept by the hybrid plan (0.0 = pure rolls)
    - ``engaged``: whether ``embedded._shift_plan`` accepts the column

    ``codomain_size`` is the length of the gathered field (the size of
    ``conn.codomain``'s range) and must be >= 1.  ``own_start`` is the
    start of the gathered field's unit range — at remap time the plan
    key uses the field's ACTUAL start, so pass the same value here or
    ``engaged`` can misreport for fields whose range does not start
    at 0.
    """
    from gt4py_tpu.next.embedded import (
        _MAX_SHIFT_CLASSES,
        _shift_plan,
    )

    table = np.asarray(conn.table)
    n = int(codomain_size)
    if n < 1:
        raise ValueError(f"codomain_size must be >= 1, got {n}")
    report = []
    for c in range(table.shape[1]):
        t = table[:, c].astype(np.int64) - int(own_start)
        valid = np.ones(t.shape, dtype=bool)
        if conn.skip_value is not None:
            valid = table[:, c] != conn.skip_value
        in_range = (t >= 0) & (t < n)
        core = valid & in_range
        d = (np.clip(t, 0, n - 1) - (np.arange(t.shape[0]) % n)) % n
        n_classes = int(len(np.unique(d[core]))) if core.any() else 0
        plan = _shift_plan(conn, c, int(own_start), n)
        residual = 0.0
        if plan is not None and plan.res_rows is not None and valid.any():
            residual = len(plan.res_rows) / int(valid.sum())
        report.append(
            {
                "column": c,
                "n_classes": n_classes,
                "max_classes": _MAX_SHIFT_CLASSES,
                "residual_frac": round(float(residual), 4),
                "engaged": plan is not None,
            }
        )
    return report


def spatial_renumbering(
    coords: np.ndarray,
    *,
    tile: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Row-major (optionally tiled) numbering from element coordinates.

    ``coords`` is ``(n, d)`` — one spatial coordinate per element; the
    LAST coordinate varies fastest (row-major).  With ``tile`` (one
    length per coordinate, in coordinate units), elements are ordered by
    tile first and row-major inside each tile — the layout that keeps a
    tile's neighbors at near-constant index offsets for grid-like
    meshes.

    Returns ``perm`` with ``perm[old_id] = new_id``.
    """
    coords = np.asarray(coords)
    if coords.ndim == 1:
        coords = coords[:, None]
    keys = []
    if tile is not None:
        if len(tile) != coords.shape[1]:
            raise ValueError(
                f"tile has {len(tile)} entries for {coords.shape[1]} coordinates"
            )
        for c in range(coords.shape[1]):
            keys.append(np.floor_divide(coords[:, c], tile[c]))
    for c in range(coords.shape[1]):
        keys.append(coords[:, c])
    # np.lexsort sorts by the LAST key first -> feed keys reversed.
    order = np.lexsort(tuple(k for k in reversed(keys)))  # new_id -> old_id
    perm = np.empty(coords.shape[0], dtype=np.int64)
    perm[order] = np.arange(coords.shape[0])
    return perm


@dataclasses.dataclass(frozen=True)
class Renumbering:
    """A consistent relabelling of one element kind (vertices, edges, ...).

    ``perm[old_id] = new_id``.  Apply it to EVERY object indexed by that
    element kind: field data over the dimension, connectivity tables
    whose SOURCE is the dimension (row order changes), and connectivity
    tables whose CODOMAIN is the dimension (stored indices change).
    """

    dim: Dimension
    perm: np.ndarray  # int64, perm[old] = new

    def __post_init__(self):
        perm = np.asarray(self.perm, dtype=np.int64)
        n = perm.shape[0]
        if not np.array_equal(np.sort(perm), np.arange(n)):
            raise ValueError("perm is not a permutation of 0..n-1")
        object.__setattr__(self, "perm", perm)
        object.__setattr__(self, "_inv", np.argsort(perm))

    @property
    def inverse(self) -> np.ndarray:
        """``inverse[new_id] = old_id``."""
        return self._inv

    def permute_data(self, arr):
        """Reorder field data over ``dim`` (axis 0): new[i] = old at the
        element now numbered i."""
        return np.asarray(arr)[self._inv]

    def apply(self, conn: Connectivity) -> Connectivity:
        """Relabel a connectivity: rows reorder if ``conn.source_dim`` is
        ``dim``; stored indices relabel if ``conn.codomain`` is ``dim``.
        Both can apply (self-referencing tables).  Skip values survive.

        Out-of-range stored indices (other than the skip value) are
        CLAMPED to ``[0, n-1]`` before relabelling — this bakes in the
        framework's clamp-gather semantics, so such rows become ordinary
        in-range indices and are no longer identifiable as out-of-range
        in diagnostics after renumbering.  Run
        ``shift_structure_report`` BEFORE renumbering if you need to see
        them."""
        table = np.asarray(conn.table)
        if conn.codomain == self.dim:
            relabeled = self.perm[np.clip(table, 0, len(self.perm) - 1)]
            if conn.skip_value is not None:
                relabeled = np.where(table == conn.skip_value, conn.skip_value, relabeled)
            table = relabeled
        if conn.source_dim == self.dim:
            table = table[self._inv]
        return Connectivity(
            table,
            domain_dims=conn.domain_dims,
            codomain=conn.codomain,
            skip_value=conn.skip_value,
        )
