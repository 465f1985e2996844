"""Shared JAX runtime config: the persistent compilation cache.

Compiling the device steps (the DP scans, the walk, the mesh steps) takes
seconds per shape; the persistent cache makes that a one-time cost per
machine.  Where the cache lives:

- $JAX_COMPILATION_CACHE_DIR when it is set -- JAX reads the variable
  itself, and this module then sets no directory;
- otherwise the fixed, git-ignored <repo>/.jax_cache.  The path is part of
  the cache's key, so it must not change between runs.

A process pinned to the CPU (JAX_PLATFORMS=cpu, as the tests are) keeps no
cache of its own: XLA:CPU entries record the compiling process's CPU
feature flags and warn of SIGILL when another process loads them, and CPU
compiles take seconds.

Only configuration is set here: importing this module, or calling
ensure_jax_cache, starts no backend (jax.distributed.initialize must be
able to run first).
"""
from __future__ import annotations

import os
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def ensure_jax_cache() -> None:
    import jax

    if (jax.config.jax_platforms or "").split(",") == ["cpu"]:
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    # compiles under a second aren't worth the disk round-trip
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
