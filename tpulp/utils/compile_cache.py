"""JAX's persistent compilation cache, kept in one fixed place.

``JAX_COMPILATION_CACHE_DIR`` wins where it is set (JAX reads it itself);
otherwise the cache lives in ``.jax_cache`` at the root of the checkout
(listed in ``.gitignore``). The path is part of every cache key, so it is
never temporary, per-process or time-derived.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The cache directory for ``environ`` (``os.environ`` by default)."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or REPO_CACHE


def enable_compile_cache() -> str:
    """Point JAX at ``compile_cache_dir()``; call before the first compile.
    Returns the directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
