"""Process-wide JAX configuration helpers.

enable_persistent_cache() turns on XLA's on-disk compilation cache so the
destripe/NCC/decon executables compile once per machine, not once per
process.  The cache lives where JAX_COMPILATION_CACHE_DIR says when that
is set (JAX reads the variable itself, so no other directory is set
here); otherwise at a fixed directory inside the checkout, so every
process of one checkout shares it.  Safe to call multiple times.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path:
    """The compilation cache directory this process uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_CACHE_DIR


def enable_persistent_cache() -> None:
    import jax

    path = cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    # IPP_TPU_XLA_CACHE_MIN_COMPILE=0 stores EVERY compile — used by the
    # warmup completeness test to catch programs the warmup tool misses;
    # production keeps the 1 s threshold
    min_secs = float(os.environ.get("IPP_TPU_XLA_CACHE_MIN_COMPILE", "1.0"))
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
