"""JAX's persistent compilation cache, at one fixed place per checkout."""

from __future__ import annotations

import os

import jax

# <checkout>/.jax_cache (git-ignored).  The path is part of the cache's key,
# so it must not move between runs: no temporary name, pid or time in it.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache before the first compile.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins and no other directory is
    set; otherwise the cache lives in the checkout.  Returns the directory.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
