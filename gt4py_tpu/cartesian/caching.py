"""Stencil fingerprinting and compilation caching.

Counterpart of the reference's ``JITCachingStrategy``
(/root/reference/src/gt4py/cartesian/caching.py:159): the fingerprint is a
hash of (definition source, backend, externals, dtypes, literal precisions,
API version). The reference stores generated source trees under
``.gt_cache``; here the analog artifacts are XLA executables, which persist
via JAX's own compilation cache — :func:`enable_persistent_cache` turns it
on.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import textwrap
from typing import Callable

from gt4py_tpu.config import CACHE_ROOT as GT_CACHE_ROOT

API_VERSION = "1"


def stencil_fingerprint(definition: Callable, build_options: dict) -> str:
    try:
        source = textwrap.dedent(inspect.getsource(definition))
    except OSError:
        source = repr(definition)
    parts = [
        API_VERSION,
        getattr(definition, "__module__", ""),
        getattr(definition, "__qualname__", ""),
        source,
        str(build_options.get("backend")),
        repr(sorted(build_options.get("externals", {}).items())),
        repr(sorted((k, str(v)) for k, v in build_options.get("dtypes", {}).items())),
        str(build_options.get("literal_int_precision")),
        str(build_options.get("literal_float_precision")),
        str(build_options.get("name")),
        # backend options change the pass pipeline (skip/add steps), so a
        # custom PassPipeline must not reuse another pipeline's artifacts
        repr(sorted((k, repr(v)) for k, v in build_options.get("backend_opts", {}).items())),
    ]
    return hashlib.sha256("\x00".join(parts).encode()).hexdigest()


_persistent_cache_enabled = False


def enable_persistent_cache(path: str | None = None) -> None:
    """Turn on JAX's persistent compilation cache so XLA executables
    survive process restarts (the reference's ``.gt_cache`` role,
    cartesian/caching.py:231). Where ``JAX_COMPILATION_CACHE_DIR`` is set,
    JAX already keeps the cache there and no directory is set here;
    otherwise it goes to ``path`` or to ``xla_cache`` under the fixed
    GT_CACHE_ROOT."""
    global _persistent_cache_enabled
    if _persistent_cache_enabled:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache_dir = path or os.path.join(GT_CACHE_ROOT, "xla_cache")
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _persistent_cache_enabled = True
