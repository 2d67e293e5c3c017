"""Persistent JAX compilation cache, kept in one fixed place.

The rule: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it
and nothing is set in code; otherwise the cache lives in ``.jax_cache`` at
the root of the checkout (listed in ``.gitignore``).  The directory is
fixed because its path is part of the cache key: a directory that moves
from run to run never hits.
"""
from __future__ import annotations

import os

__all__ = ["ENV_VAR", "compile_cache_dir", "enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=None) -> str:
    """The directory the persistent compilation cache uses."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on (see the module rule); returns its dir.

    Caches programs whose compile took a second or more.
    """
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return compile_cache_dir()
