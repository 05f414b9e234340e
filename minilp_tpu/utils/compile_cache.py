"""Placement of JAX's persistent compilation cache for the entry scripts.

The library itself sets no cache.  `bench.py` and `chip_smoke.py` call
`configure(__file__)`: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
and nothing is set here; otherwise the cache goes to ``.jax_cache`` beside
the calling script, so every run from one checkout reuses one directory.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"


def configure(script_file: str) -> str:
    """Point the compile cache at its directory and return that directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    path = str(Path(script_file).resolve().parent / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
