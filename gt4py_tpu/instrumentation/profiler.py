"""GPU profiling helpers.

Counterpart of the reference's GPU profiler (CUDA events + NVTX ranges,
/root/reference/src/gt4py/next/instrumentation/gpu_profiler.py:48-233):
here the equivalents are the JAX profiler (XPlane traces viewable in
TensorBoard/XProf) and ``jax.named_scope`` annotations. Enable trace
markers with ``GT4PY_ADD_GPU_TRACE_MARKERS=1`` (reference
next/config.py:150).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, Optional


_MARKERS_ENABLED = os.environ.get("GT4PY_ADD_GPU_TRACE_MARKERS", "0") not in (
    "0",
    "",
    "false",
    "False",
)


@contextlib.contextmanager
def named_scope(name: str) -> Iterator[None]:
    """Annotate enclosed JAX ops in profiler traces (no-op unless markers
    are enabled)."""
    if not _MARKERS_ENABLED:
        yield
        return
    import jax

    with jax.named_scope(name):
        yield


@contextlib.contextmanager
def gpu_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a device trace around the enclosed block
    (``jax.profiler.trace``); view with xprof/TensorBoard."""
    import jax

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "gt4py_gpu_trace")
    with jax.profiler.trace(log_dir):
        yield
