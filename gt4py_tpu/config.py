"""Environment-driven configuration flags.

Unifies the reference's two config systems — ``cartesian/config.py``
(/root/reference/src/gt4py/cartesian/config.py:20-94: build/cache settings)
and ``next/config.py`` (/root/reference/src/gt4py/next/config.py:59-212:
typed env parsing, debug/cache/JIT flags) — into one module. Values are
read once at import; tests may monkeypatch module attributes directly.

Environment variables honored (reference names kept where meaningful):

- ``GT_CACHE_ROOT``           cache root directory (default ``.gt_cache`` beside
                              the package, whatever the working directory)
- ``GT_CACHE_DIR_NAME``       subdirectory name for per-project caches
- ``GT4PY_DEBUG``             verbose exceptions + debug artifacts
- ``GT4PY_VERBOSE_EXCEPTIONS``
- ``GT4PY_JIT``               default enable_jit for field operators
- ``GT4PY_BUILD_CACHE_LIFETIME``  ``session`` | ``persistent``
- ``GT4PY_COLLECT_METRICS_LEVEL`` (instrumentation/metrics.py)
- ``GT4PY_DUMP_METRICS_AT_EXIT``
- ``GT4PY_ADD_GPU_TRACE_MARKERS`` (instrumentation/profiler.py)
- ``JAX_COMPILATION_CACHE_DIR``  read by JAX itself; when set, the
                              persistent compile cache lives there
                              (cartesian/caching.py)
"""

from __future__ import annotations

import enum
import os
import tempfile
from typing import Final


def env_flag_to_bool(name: str, default: bool) -> bool:
    """Parse a boolean env var (reference: next/config.py:59)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(f"Invalid boolean value {raw!r} for environment variable {name}")


def env_flag_to_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"Invalid integer value {raw!r} for environment variable {name}") from None


class BuildCacheLifetime(enum.Enum):
    """Reference: next/config.py:110 (SESSION deletes at exit, PERSISTENT keeps)."""

    SESSION = "session"
    PERSISTENT = "persistent"


#: Master debug switch (reference GT4PY_DEBUG, next/config.py:96).
DEBUG: Final[bool] = env_flag_to_bool("GT4PY_DEBUG", False)

#: Pretty-printed DSL exceptions with source frames (next/config.py:104).
VERBOSE_EXCEPTIONS: bool = env_flag_to_bool("GT4PY_VERBOSE_EXCEPTIONS", DEBUG)

#: Default JIT enablement for field operators without explicit backend.
ENABLE_JIT: bool = env_flag_to_bool("GT4PY_JIT", True)

#: Root of all persistent caches (reference GT_CACHE_ROOT, cartesian/config.py:83):
#: a fixed path beside the package, so every process of a checkout finds the
#: same caches whatever its working directory.
CACHE_ROOT: str = os.environ.get(
    "GT_CACHE_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".gt_cache"),
)

#: Per-project cache directory name (reference GT_CACHE_DIR_NAME).
CACHE_DIR_NAME: str = os.environ.get("GT_CACHE_DIR_NAME", "gt4py_tpu")

_lifetime_raw = os.environ.get("GT4PY_BUILD_CACHE_LIFETIME", "persistent").lower()
BUILD_CACHE_LIFETIME: BuildCacheLifetime = BuildCacheLifetime(_lifetime_raw)


def cache_dir() -> str:
    """Resolved cache directory honoring the lifetime setting."""
    if BUILD_CACHE_LIFETIME is BuildCacheLifetime.SESSION:
        d = os.path.join(tempfile.gettempdir(), f"gt4py_tpu_session_{os.getuid()}")
    else:
        d = os.path.join(CACHE_ROOT, CACHE_DIR_NAME)
    os.makedirs(d, exist_ok=True)
    return d
