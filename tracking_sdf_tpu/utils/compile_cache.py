"""Location of JAX's persistent compilation cache for the entry points.

The cache key does not contain the directory, but a directory that moves
between runs never hits, so the default is a fixed path inside the
checkout (listed in .gitignore). An explicit ``JAX_COMPILATION_CACHE_DIR``
wins: JAX reads that variable itself, and nothing here overrides it.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
