"""Small shared utilities (reference mimo/utils.py:4-14)."""

from __future__ import annotations

import os
from argparse import ArgumentTypeError

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dir_path(path: str) -> str:
    """argparse validator: the argument must be an existing directory."""
    if os.path.isdir(path):
        return path
    raise ArgumentTypeError(f"{path} is not a valid path")


def enable_compile_cache() -> str:
    """Give JAX's persistent compilation cache one fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing is configured here.  Otherwise the cache lives in
    ``<checkout>/.jax_cache`` (listed in .gitignore) — a fixed path,
    because the path is part of what makes a later process hit the cache.
    Every entry point calls this before its first compile.  Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def count_trainable_parameters(params) -> int:
    from mimo_unet_tpu.models import count_parameters

    return count_parameters(params)
