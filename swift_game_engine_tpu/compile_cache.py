"""Where JAX keeps this program's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, names the directory and JAX reads
it itself; nothing here overrides it. Otherwise the cache lives at one
fixed path inside the checkout, ``.jax_cache/`` (listed in .gitignore): the
path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn the persistent compile cache on; returns its directory."""
    path = os.environ.get(ENV)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
