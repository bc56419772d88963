"""The one place that points JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache is
the fixed ``<repo>/.jax_cache`` (the path is part of the cache key, so a
directory that moves never hits).  Call before the first compile; safe to
call more than once.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


def enable_persistent_cache() -> str:
    """Point jax's compilation cache at :func:`cache_dir`; returns it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
