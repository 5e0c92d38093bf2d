"""Persistent XLA compilation cache.

The reference pays no compile cost (MSBuild AOT for CUDA,
D3DX11CompileFromFile once per run, Shader.hpp:14-21); a jit program
here compiles on its first call in every process. JAX's persistent
compilation cache turns that into a disk read after the first process.
Every entry point (CLI, bench, chip_smoke, tools) calls
`enable_compile_cache` before its first `jit` call.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and the
cache lives there; nothing else is set. Otherwise the cache lives in
the fixed ``<repo>/.jax_cache`` (a fixed path, because the directory is
part of the cache key).
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache (idempotent) and
    return the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything — even sub-second programs; the bench/CLI
    # workloads re-run identical programs every process.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
