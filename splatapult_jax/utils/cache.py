"""JAX's persistent compilation cache at one fixed place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing is
changed here. Otherwise the cache lives in ``.jax_cache/`` at the root of the
checkout, a fixed path (the path is part of the cache key, so a moving
directory would never hit). The directory is listed in ``.gitignore``. On the
CPU nothing is cached: CPU programs compile fast, and cached CPU executables
are tied to the host's instruction set.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache():
    """Point JAX's persistent cache at its directory -> the directory used
    (None on the CPU)."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CACHE_DIR
