"""Persistent XLA compilation cache.

A cold compile of a full model step takes seconds to minutes and is
paid again by every process (benchmarks, the smoke run, user scripts).
JAX's persistent compilation cache serializes compiled executables
keyed by HLO and compile options, so recompiling an unchanged step in a
new process becomes a file read.

Where the cache lives: the directory ``JAX_COMPILATION_CACHE_DIR``
names, when that variable is set (no other directory is ever set);
otherwise ``<checkout>/.jax_cache``, one fixed path inside the checkout
(listed in ``.gitignore``), so that a later process finds what an
earlier one compiled.
"""
from __future__ import annotations

import os

#: the cache directory used when JAX_COMPILATION_CACHE_DIR is unset
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir():
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_persistent_cache():
    """Enable JAX's persistent compilation cache at ``cache_dir()``
    (idempotent)."""
    import jax
    path = cache_dir()
    if jax.config.jax_compilation_cache_dir == path:
        return
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
