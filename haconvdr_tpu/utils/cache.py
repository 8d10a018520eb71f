"""Persistent XLA compilation cache.

Compiling the large jitted programs (train step, encoder, search) takes
tens of seconds to minutes; the persistent cache lets every run after the
first reuse them.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads
it itself and nothing here overrides it.  Otherwise the cache lives at the
fixed path ``<checkout>/.jax_cache`` (listed in .gitignore) — a fixed path,
because the directory is part of what makes a later run find the entries.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compilation_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compilation_cache_dir` and return that directory."""
    import jax

    cache_dir = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
