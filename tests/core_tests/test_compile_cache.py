"""Where the persistent XLA compile cache lands (cartesian/caching.py).

Each case runs in a child process started in a foreign working directory,
because JAX reads ``JAX_COMPILATION_CACHE_DIR`` when it is imported."""

import os
import subprocess
import sys

import gt4py_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(gt4py_tpu.__file__)))
PROBE = (
    "from gt4py_tpu.cartesian.caching import enable_persistent_cache\n"
    "enable_persistent_cache()\n"
    "import jax\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def _cache_dir_in_child(tmp_path, extra_env):
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_COMPILATION_CACHE_DIR", "GT_CACHE_ROOT")}
    env.update(extra_env, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_env_dir_is_used_and_none_is_set_in_code(tmp_path):
    target = tmp_path / "from_env"
    assert _cache_dir_in_child(tmp_path, {"JAX_COMPILATION_CACHE_DIR": str(target)}) == str(target)


def test_default_dir_is_fixed_inside_the_checkout(tmp_path):
    """Not derived from the working directory: the child runs in tmp_path."""
    got = _cache_dir_in_child(tmp_path, {})
    assert got == os.path.join(REPO, ".gt_cache", "xla_cache")
    assert str(tmp_path) not in got
