"""JAX's persistent compilation cache, in one place for every entry
point (cli, bench.py, chip_smoke.py)."""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Keep compiled executables across processes. Where
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other
    directory is set here; otherwise the cache lives in
    <checkout>/.jax_cache. Returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
