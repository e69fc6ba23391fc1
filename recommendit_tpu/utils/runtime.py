"""Process-level runtime setup shared by the entry points.

``enable_compile_cache`` is called by ``chip_smoke.py``, ``bench.py``, the
pipeline CLI and ``serving.app.serve`` — never at package import, so
library users and tests keep JAX's own defaults.
"""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache goes to the fixed
    ``<repo>/.jax_cache``: the path is part of the cache key, so it never
    depends on a temp name, a pid or the time.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit`` CSV), read by a child process that stays off
    JAX; "not available" when ``nvidia-smi`` cannot answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip() or "not available"
