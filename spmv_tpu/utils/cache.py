"""Persistent XLA compilation cache.

Large SpMV plans take seconds to compile; the persistent cache lets a
repeat run (bench reruns, test runs, the chip smoke) load executables
from disk instead.  The executable analog of the reference's
preprocessed-matrix binary cache (mmio_highlevel.h:531-584).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
module sets nothing.  Otherwise the cache lives at a fixed path inside the
checkout (``<checkout>/.jax_cache``): the directory is part of the cache
key, so a path that moved between runs would never hit.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "DEFAULT_DIR"]

#: fixed default: ``.jax_cache`` at the root of the checkout
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_enabled = False


def enable_compile_cache(path: str = None) -> str:
    """Idempotently enable the JAX persistent compilation cache.

    Returns the directory in use.  An explicit ``path`` wins; else
    ``JAX_COMPILATION_CACHE_DIR``, which JAX reads itself, so nothing is
    set here; else :data:`DEFAULT_DIR`.
    """
    global _enabled
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path is None and env:
        return env
    d = path or DEFAULT_DIR
    if not _enabled:
        import jax
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _enabled = True
    return d
