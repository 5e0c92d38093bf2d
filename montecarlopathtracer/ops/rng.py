"""Counter-based random streams for the wavefront integrator.

The reference uses stateful per-thread RNGs (cuRAND seeded from
pixel+seed, CUTracer.cu:186-187; a TEA-hash seeded LCG, rtx.hlsl:61-82).
A wavefront wants *stateless, counter-based* draws instead: every
uniform is a pure function of (base key, stream id), so

- the same key replays the exact same paths (the backward pass re-traces
  decisions without storing them — path replay gradients), and
- sharding samples across devices only needs per-device key folding,
  no RNG state to carry or synchronize.

Streams are identified by small integers; `stream_uniform` returns a
whole ``[R]`` batch of iid uniforms per call (one threefry block per
lane, fused by XLA).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def stream_uniform(key: jax.Array, stream_id, shape) -> jnp.ndarray:
    """Uniform [0, 1) draws for the given stream of the base key.

    ``stream_id`` may be a Python int or a traced scalar (e.g. the scan
    segment index), making per-bounce streams cheap inside `lax.scan`.
    """
    k = jax.random.fold_in(key, stream_id)
    return jax.random.uniform(k, shape, dtype=jnp.float32)


def make_key(seed: int) -> jax.Array:
    """Base key for rendering: threefry on every platform, so renders
    are bit-stable across runs and the CPU tests pin exact values."""
    return jax.random.key(seed)
