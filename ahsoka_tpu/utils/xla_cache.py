"""Persistent XLA compilation cache.

Every device stage is an XLA program whose first compile takes seconds;
jax's persistent compilation cache lets repeat runs skip those compiles.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, jax reads it itself and this
module sets nothing.  Otherwise the cache lives at one fixed directory
inside the checkout, ``<repo>/.jax_cache`` (gitignored): the path is part
of what makes a later run find the entries again.
"""

from __future__ import annotations

import os

_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compilation_cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(_ENV) or DEFAULT_DIR


def enable_persistent_compilation_cache() -> str:
    """Point jax at the on-disk compilation cache (idempotent); returns
    its directory."""
    if os.environ.get(_ENV):
        return os.environ[_ENV]
    import jax

    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
