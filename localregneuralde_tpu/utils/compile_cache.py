"""Where compiled XLA programs are kept between processes.

Compiling the stored-adjoint train step takes a large share of a short
run, and JAX can reuse a compiled program from disk when the same program
is compiled again. ``JAX_COMPILATION_CACHE_DIR`` names the directory when
it is set (JAX reads the variable itself); otherwise the cache lives at a
fixed path inside the checkout, because the path is part of the cache key
and a directory that moves never hits.
"""
from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` if set, else
    ``<repo>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.
    Sets no directory in code when the environment already names one."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
