"""Persistent XLA compilation cache for the entry points.

The trial-grid programs take long to compile, and the CLI, bench.py,
chip_smoke.py and the test processes each start cold.  The cache lives
where JAX_COMPILATION_CACHE_DIR says when it is set; otherwise at one
fixed directory inside the checkout (`.jax_cache`, git-ignored).  The
path is part of what lets a later process find the entries, so it is
never a temporary or per-process name.
"""
from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.  Idempotent; call before the first compile."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
