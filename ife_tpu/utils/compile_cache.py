"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the `ife` CLI, bench.py, chip_smoke.py):
if JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
else is set here; otherwise the cache lives at the fixed path
<checkout>/.jax_cache. The path is part of the cache's key, so it must
not move between runs.
"""
from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
