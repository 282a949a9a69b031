"""Backend ABC and registry (reference: cartesian/backend/base.py:35,129).

A backend turns an :class:`AnalyzedStencil` into a runnable computation.
Unlike the reference — which generates source code, compiles extension
modules and imports them — backends here build Python callables around the
GTIR trace; XLA is the code generator and its persistent compilation cache
plays the role of the reference's ``.gt_cache`` (see caching.py).
"""

from __future__ import annotations

import abc
from typing import Any, Type

from gt4py_tpu.cartesian.passes.pipeline import AnalyzedStencil

REGISTRY: dict[str, Type["Backend"]] = {}


def register(cls: Type["Backend"]) -> Type["Backend"]:
    REGISTRY[cls.name] = cls
    return cls


def from_name(name: str) -> Type["Backend"]:
    if name not in REGISTRY:
        raise ValueError(
            f"Unknown backend '{name}'. Registered backends: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


class Backend(abc.ABC):
    """One compiled stencil on one backend."""

    #: registry name, e.g. "jax", "numpy", "debug", "gpu"
    name: str = ""
    #: which array type the backend consumes: "jax" or "numpy"
    array_kind: str = "jax"
    #: storage/layout info for the storage layer (API parity with
    #: reference Backend.storage_info)
    storage_info: dict = {"alignment": 1, "device": "cpu"}

    def __init__(self, analyzed: AnalyzedStencil, options: dict):
        self.analyzed = analyzed
        self.options = options

    @abc.abstractmethod
    def run(
        self,
        arrays: dict[str, Any],
        scalars: dict[str, Any],
        domain: tuple[int, int, int],
        origins: dict[str, tuple[int, int, int]],
    ) -> dict[str, Any]:
        """Execute; return {written_field_name: updated_array}."""

    #: backends whose ``run`` keys a dispatch cache can skip rebuilding the
    #: per-call shapes key when the runtime hands down its identity-free
    #: validation-cache key (shapes/dtypes/origins/domain — see
    #: stencil_object._call_run)
    accepts_cache_key = False

    def run_from_infos(
        self,
        infos: dict[str, Any],
        scalars: dict[str, Any],
        domain: tuple[int, int, int],
        origins: dict[str, tuple[int, int, int]],
        cache_key: Any = None,
    ) -> dict[str, Any]:
        """Execute from per-argument infos (lazy arrays)."""
        import numpy as np

        arrays = {}
        for name, info in infos.items():
            value = info.array
            if self.array_kind == "jax":
                if isinstance(value, np.ndarray):
                    import jax.numpy as jnp

                    value = jnp.asarray(value)
            else:
                value = np.asarray(value)
                if not value.flags.writeable:
                    value = value.copy()  # JAX buffers are read-only views
            arrays[name] = value
        if self.accepts_cache_key:
            return self.run(arrays, scalars, domain, origins, cache_key=cache_key)
        return self.run(arrays, scalars, domain, origins)

    def run_chained_from_infos(
        self,
        infos: dict[str, Any],
        scalars: dict[str, Any],
        domain: tuple[int, int, int],
        origins: dict[str, tuple[int, int, int]],
        n_steps: int,
        swap: dict[str, str],
    ) -> dict[str, Any]:
        """Run ``n_steps`` applications with buffer rotation between steps
        (``swap[role] = source_role``: the buffer serving ``source_role``
        after a step serves ``role`` in the next). Semantically equal to
        the user's Python time loop; accelerated backends override this to
        run the whole chain on-device in one executable (the per-call
        dispatch overhead then amortizes to ~0). This generic fallback
        loops single steps — the oracle backends' behavior.

        Returns updated arrays for every role whose buffer content can
        have changed (written roles and members of swap cycles)."""
        import numpy as np

        state: dict[str, Any] = {}
        for name, info in infos.items():
            value = info.array
            if self.array_kind == "numpy":
                value = np.array(value)  # private copy: steps may mutate
            else:
                if isinstance(value, np.ndarray):
                    import jax.numpy as jnp

                    value = jnp.asarray(value)
            state[name] = value
        dirty = chain_dirty_roles(self.analyzed, infos, swap)
        for _ in range(int(n_steps)):
            out = self.run_from_infos(
                {n: _ChainInfo(v) for n, v in state.items()},
                scalars,
                domain,
                origins,
            )
            after = {**state, **out}
            state = {r: after[swap.get(r, r)] for r in state}
        return {r: state[r] for r in dirty}


class _ChainInfo:
    """Minimal ArgsInfo stand-in for arrays already materialized by a
    chained run (run_from_infos only reads ``.array``/``.original``)."""

    __slots__ = ("original",)

    def __init__(self, array):
        self.original = array

    @property
    def array(self):
        return self.original

    @property
    def shape(self):
        return tuple(self.original.shape)

    @property
    def dtype(self):
        import numpy as np

        return np.dtype(self.original.dtype)


def chain_dirty_roles(analyzed, infos, swap: dict[str, str]) -> list[str]:
    """Roles whose buffer content can change over a chained run: written
    fields plus every member of a swap cycle (rotation moves content even
    through read-only roles)."""
    from gt4py_tpu.cartesian.definitions import AccessKind

    dirty = {
        name
        for name in infos
        if analyzed.field_infos[name].access & AccessKind.WRITE
    }
    dirty.update(swap.keys())
    dirty.update(swap.values())
    return sorted(dirty)


def chain_cycle_len(roles, swap: dict[str, str]) -> int:
    """Smallest C with swap^C == identity on ``roles`` (the body unroll
    that returns every buffer to its own loop-carry slot, so XLA's while
    loop keeps them in place instead of copying between slots)."""
    cur = {r: swap.get(r, r) for r in roles}
    c = 1
    while any(cur[r] != r for r in roles):
        cur = {r: swap.get(cur[r], cur[r]) for r in roles}
        c += 1
        if c > len(roles) + 1:
            raise ValueError(f"swap mapping is not a permutation: {swap!r}")
    return c
