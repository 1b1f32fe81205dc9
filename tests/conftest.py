"""Test harness: run everything on a virtual 8-device CPU mesh.

Must set XLA flags before jax initializes its backends, hence the env
mutation at import time (conftest is imported before any test module).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
# The entry points turn JAX's persistent compilation cache on
# (tracking_sdf_tpu/utils/compile_cache.py); the suite's small CPU programs
# are not worth keeping, and several workers would share one directory.
# The env var reaches the CLI subprocesses some tests launch.
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Forcing the config as well as the env var keeps the whole suite on the
# virtual 8-device CPU mesh even where JAX would default to a GPU; the
# card-side check is chip_smoke.py (pytest marker `gpu` for card-only tests).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
jax.config.update("jax_enable_compilation_cache", False)
