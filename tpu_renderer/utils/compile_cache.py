"""Persistent XLA compilation cache for the entry points.

Entry points (``chip_smoke.py``, ``bench.py``, ``examples/*``, the test
suite) call :func:`enable_compile_cache` once before their first compile; the
library never does so at import.
"""
from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

#: ``.jax_cache/`` at the repository root (listed in .gitignore). A fixed
#: path, because the path is part of the cache's key.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``JAX_COMPILATION_CACHE_DIR``
    when that is set, else at :data:`DEFAULT_CACHE_DIR`. Returns the path."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
