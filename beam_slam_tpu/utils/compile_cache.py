"""Persistent XLA compilation cache.

The cache directory is part of each entry's key, so it must not move
between runs: ``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise
the cache lives at a fixed directory inside the checkout
(``<repo>/.jax_cache``, listed in ``.gitignore``). This is the only place
the program sets a cache directory.

Call :func:`enable` BEFORE the first jit compilation (importing jax is
fine; compiling is not).
"""

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable(min_compile_secs: float = 2.0) -> str:
    """Turn on the persistent cache and return its directory."""
    import jax

    cache_dir = os.environ.get(ENV_VAR) or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return cache_dir
