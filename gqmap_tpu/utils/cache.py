"""JAX's persistent compilation cache, kept at one fixed place.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself);
otherwise the cache lives in ``<checkout>/.jax_cache``. The path is part of
the cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache"]

_DEFAULT = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; return its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.fspath(_DEFAULT)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
