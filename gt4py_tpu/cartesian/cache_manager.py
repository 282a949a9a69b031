"""Cache inspection and cleaning.

Counterpart of the reference's ``gt4py.cartesian.gt_cache_manager``:
enumerate and clean the persistent cache tree (here GT_CACHE_ROOT holds
the XLA executable cache, the native helper library, and any workflow-step
caches).
"""

from __future__ import annotations

import os
import shutil
from gt4py_tpu.cartesian.caching import GT_CACHE_ROOT


def cache_info(root: str | None = None) -> dict:
    """Sizes (bytes) and entry counts per cache subsystem."""
    root = root or GT_CACHE_ROOT
    info: dict = {"root": root, "subsystems": {}, "total_bytes": 0}
    if not os.path.isdir(root):
        return info
    for entry in sorted(os.listdir(root)):
        path = os.path.join(root, entry)
        size = 0
        count = 0
        if os.path.isdir(path):
            for dirpath, _, files in os.walk(path):
                for f in files:
                    try:
                        size += os.path.getsize(os.path.join(dirpath, f))
                        count += 1
                    except OSError:
                        pass
        else:
            size = os.path.getsize(path)
            count = 1
        info["subsystems"][entry] = {"bytes": size, "entries": count}
        info["total_bytes"] += size
    return info


def clean_cache(root: str | None = None, *, subsystem: str | None = None) -> None:
    """Remove the cache tree (or one subsystem, e.g. ``xla_cache``,
    ``native``)."""
    root = root or GT_CACHE_ROOT
    if subsystem is not None:
        target = os.path.join(root, subsystem)
        if os.path.isdir(target):
            shutil.rmtree(target, ignore_errors=True)
        elif os.path.isfile(target):
            os.unlink(target)
        return
    if os.path.isdir(root):
        shutil.rmtree(root, ignore_errors=True)
