"""Differentiable rendering: pixel-loss gradients w.r.t. scene params.

The reference has no differentiability at all — this is the framework's
headline extension (BASELINE.json north star: gradients w.r.t. vertex
positions, BSDF albedos and emitter radiance). Strategy: *detached
sampling with path replay*.

- All sampling decisions (directions, lobe/RR choices) are functions of
  counter-based uniforms (`ops.rng`) that carry no gradient — JAX's AD
  never differentiates through the discrete decisions.
- The radiance estimate is differentiable through: throughput products
  (× Kd/Ks/Ka), the emitter value (Ka × illum), and the hit geometry
  (β, γ, t flow through the per-triangle transforms → vertex
  positions; shading normals flow through the normal buffer).
- Memory: the bounce scan body is `jax.checkpoint`ed, so the backward
  pass *replays* each segment (re-intersecting with the same keys)
  instead of storing per-segment intermediates — path-replay
  backpropagation, exact because the PRNG is stateless.

The parameter pytree is an explicit subset of :class:`ScenePack` fields
(`param_overlay`), so `jax.grad` sees only the degrees of freedom asked
for: e.g. ``{"mat_kd": ..., "mat_ka": ...}`` for the inverse-rendering
config of BASELINE.json (recover wall albedo + light radiance), or
``{"vertices": ...}`` for geometry optimization.

Known limitation (by the math, not the implementation): with the
reference's simplified material model every geometric factor cancels
against its importance sampler, so path radiance is a product of
albedos × Ka only — piecewise *constant* in vertex positions. The
reparameterized vertex gradient is therefore exactly zero in the
interior; nonzero geometry gradients live entirely in visibility
discontinuities and need boundary/silhouette sampling (planned; cf.
differentiable-rendering literature on edge sampling / warped-area
reparameterization). Vertex parameters still flow through the whole
pipeline so such estimators can be added without restructuring.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..scene.scene import ScenePack
from ..scene.camera import Camera
from ..render.integrator import TraceConfig, render_sample_batch

PARAM_FIELDS = (
    "vertices",
    "normals",
    "mat_ka",
    "mat_kd",
    "mat_ks",
    "mat_ns",
    "mat_tr",
    "mat_ni",
)


def split_params(scene: ScenePack, fields: Tuple[str, ...]) -> Dict[str, jnp.ndarray]:
    """Extract the optimizable fields as a flat dict pytree."""
    for f in fields:
        if f not in PARAM_FIELDS:
            raise ValueError(f"not a differentiable field: {f}")
    return {f: getattr(scene, f) for f in fields}


def merge_params(scene: ScenePack, params: Dict[str, jnp.ndarray]) -> ScenePack:
    """Overlay parameter values onto a scene pack."""
    return dataclasses.replace(scene, **params)


def render_image(
    params: Dict[str, jnp.ndarray],
    scene: ScenePack,
    camera: Camera,
    key: jax.Array,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
) -> jnp.ndarray:
    """Differentiable spp-sample render as a function of ``params``."""
    s = merge_params(scene, params)

    def one(acc, i):
        img = render_sample_batch(
            s, camera, jax.random.fold_in(key, i), width, height, config
        )
        return acc + img, None

    if spp <= 8:
        # Small spp unrolls cheaply (and lets XLA overlap the sample
        # batches' residual traffic); large spp keeps the scan.
        total = jnp.zeros((height, width, 3), jnp.float32)
        for i in range(spp):
            total, _ = one(total, i)
    else:
        total, _ = jax.lax.scan(
            one, jnp.zeros((height, width, 3), jnp.float32), jnp.arange(spp)
        )
    return total / spp


def make_loss_fn(
    scene: ScenePack,
    camera: Camera,
    target: jnp.ndarray,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
):
    """L2 pixel loss against ``target`` as a function of (params, key)."""

    def loss_fn(params, key):
        img = render_image(
            params,
            scene,
            camera,
            key,
            width=width,
            height=height,
            spp=spp,
            config=config,
        )
        return jnp.mean((img - target) ** 2)

    return loss_fn


def make_sgd_step(loss_fn, lr: float = 0.5, param_min: float = 0.0):
    """One jitted SGD step with projection to [param_min, ∞) — radiance
    and albedo params are nonnegative."""

    @jax.jit
    def step(params, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, key)
        new_params = jax.tree.map(
            lambda p, g: jnp.maximum(p - lr * g, param_min), params, grads
        )
        return new_params, loss

    return step
