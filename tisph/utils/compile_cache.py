"""Persistent XLA compilation cache for the entry points."""

from __future__ import annotations

import os

import jax

# fixed path inside the checkout: the cache key includes the directory, so
# a path that moves between runs would never hit
_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def use_compile_cache() -> None:
    """Keep compiled programs across processes: in ``$JAX_COMPILATION_CACHE_DIR``
    when it is set (JAX reads it itself; nothing is set here), otherwise in
    ``.jax_cache/`` at the root of this checkout."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
