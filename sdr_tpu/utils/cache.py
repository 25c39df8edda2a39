"""Persistent XLA compilation cache location.

One rule for every entry point (``python -m sdr_tpu``, bench.py,
chip_smoke.py): ``$JAX_COMPILATION_CACHE_DIR`` when it is set — JAX
reads that variable itself, so nothing else is set — else the fixed
``<repo>/.jax_cache``. The path is part of the cache key, so it never
depends on a temporary directory, a PID or a timestamp.
"""

from __future__ import annotations

import os
from pathlib import Path

_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """Where compiled programs are cached for this process."""
    env = os.environ.get(_ENV)
    if env:
        return env
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir``
    and return that directory."""
    path = compile_cache_dir()
    if not os.environ.get(_ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
