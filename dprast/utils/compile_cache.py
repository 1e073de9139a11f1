"""JAX's persistent compilation cache for the entry points.

Called by the scripts users run (`chip_smoke.py`, `bench.py`,
`benchmarks/run.py`, the examples' `main`), never on library import.
"""

from __future__ import annotations

import os

import jax

# Fixed, so that the cache key (which includes the path) repeats from one
# run to the next; listed in .gitignore.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Point JAX's compilation cache at ``$JAX_COMPILATION_CACHE_DIR`` when
    that is set, else at `CHECKOUT_CACHE_DIR`; return the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
