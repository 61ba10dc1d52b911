"""Persistent XLA compilation cache for the entry points.

Every entry point (the three CLI apps, ``bench.py``, ``chip_smoke.py``)
calls :func:`enable_compile_cache` before its first compilation; importing
the package does not, so tests and library users keep JAX's defaults.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
other directory is set here. Otherwise the cache lives at the fixed path
``<checkout>/build/jax_cache``: the path is part of the cache key, so a
directory that moved between runs would never hit.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    JAX_COMPILATION_CACHE_DIR, else DEFAULT_DIR; return the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        import jax

        path = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
