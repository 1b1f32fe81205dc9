"""The measurement entry points: compile-cache location, and no result off
the card (chip_smoke.py and bench.py exit nonzero without a GPU)."""
import os
import shutil
import subprocess
import sys

import pytest

from tracking_sdf_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_CACHE_PROBE = """
from tracking_sdf_tpu.utils import compile_cache
import jax
print(compile_cache.enable_compile_cache())
print(jax.config.jax_compilation_cache_dir)
print(compile_cache.enable_compile_cache())
"""


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "unset"])
def test_compile_cache_location(env_set, tmp_path):
    """Run in a fresh interpreter: the helper changes process-wide JAX
    config."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop(compile_cache.ENV_VAR, None)
    if env_set:
        env[compile_cache.ENV_VAR] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got, config_dir, again = r.stdout.split()
    want = str(tmp_path) if env_set else os.path.join(ROOT, ".jax_cache")
    # a fixed path, the same on every call; with the variable set, JAX
    # itself reads it and the helper sets nothing else
    assert got == again == config_dir == want


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_point_fails_without_gpu(script):
    r = _run(script, ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert '"value"' not in r.stdout  # bench prints no metric line
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the checkout, the script has no program to run."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run("chip_smoke.py", str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
