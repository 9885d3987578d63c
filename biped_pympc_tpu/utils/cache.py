"""Persistent compilation cache helper.

The JAX persistent cache brings every repeat-process compile of the
controller steps down to seconds — the practical answer to the reference's
hours-per-variant CUDA code generation: the first build of a variant costs
seconds to minutes once, then it is found on disk.
"""

from __future__ import annotations

import os


def enable_compilation_cache() -> str:
    """Enable the JAX persistent compilation cache (idempotent).

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already keeps its cache
    there and this sets no other directory. Otherwise the cache lives at the
    fixed `<repo>/.jax_cache`, so benchmarks and examples share compiled
    programs across processes (the path is part of the cache key, so it
    must not move). Returns the directory in use.
    """
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            ".jax_cache",
        )
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
