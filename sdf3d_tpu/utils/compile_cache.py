"""Persistent compile cache for the entry points.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, this leaves
it alone.  Otherwise the cache lives at the fixed ``<repo>/.jax_cache`` (a
path that never changes between runs, since the path is part of what makes
a later run find the entry).
"""

from __future__ import annotations

import os
import pathlib

import jax

#: The cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
