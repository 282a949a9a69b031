"""Test configuration: run everything on CPU with 8 virtual devices so the
multi-device sharding paths are testable without GPUs, and the K-sweep
kernel runs in the Pallas interpreter.

``GT4PY_TEST_PLATFORM=gpu`` lifts the CPU pin: JAX then takes the GPU and
the ``gpu``-marked hardware tier (tests/gpu_tests) runs on the card."""

import os

# FOAST pipeline bugs must FAIL tests, not silently fall back to the raw
# definition (production default is graceful fallback with the reason
# recorded on the operator).
os.environ.setdefault("GT4PY_FOAST_STRICT", "1")

ON_GPU = os.environ.get("GT4PY_TEST_PLATFORM", "cpu") == "gpu"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
