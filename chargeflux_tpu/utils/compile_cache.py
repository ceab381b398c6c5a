"""JAX's persistent compilation cache, kept where its key stays stable.

The cache key includes the directory, so a path that moves (a temporary
name, a PID, a time stamp) never hits.  ``JAX_COMPILATION_CACHE_DIR``, when
set, names the directory and nothing here overrides it; otherwise the cache
lives at the fixed ``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

import jax

#: The checkout this package was imported from (the repository root).
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache(min_compile_time_secs: float) -> str:
    """Turn the persistent cache on for programs that took at least
    ``min_compile_time_secs`` to compile; returns its directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return path
