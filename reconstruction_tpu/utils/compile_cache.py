"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (bench.py, chip_smoke.py, tools/): when
the environment names a cache with ``JAX_COMPILATION_CACHE_DIR``, JAX
reads it itself and nothing is set in code; otherwise the cache lives at
``<checkout>/.jax_cache``.  The path is part of the cache key, so it is
fixed: never a temp name, a pid or the time.
"""

from __future__ import annotations

import os
from typing import Optional

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache_dir() -> Optional[str]:
    """The directory to set in code, or None when the environment
    already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Apply the rule above; returns the cache directory in effect."""
    import jax
    path = default_cache_dir()
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
