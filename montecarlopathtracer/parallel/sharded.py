"""SPMD rendering over a device mesh via `shard_map` + XLA collectives.

Decomposition (SURVEY.md §2.3):

- each device renders its row band of the film for its share of the
  sample batch (pure local wavefront work — the heavy compute);
- partial films are summed with `jax.lax.psum` over the ``spp`` axis —
  the only cross-device communication in the forward pass (NVLink);
- the film stays sharded over the ``rays`` axis end-to-end (it is
  produced, accumulated and checkpointed band-wise; only PNG encoding
  gathers it).

The differentiable path reuses the same program: `jax.grad` through
`shard_map` transposes the `psum` into the gradient all-reduce, so
parameter gradients are combined over the mesh exactly like the film —
no hand-written backward collectives needed.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..scene.scene import ScenePack
from ..scene.camera import Camera
from ..render.integrator import TraceConfig, render_rows, _pcast_missing
from ..render.film import Film, film_update
from .mesh import RAYS_AXIS, SPP_AXIS


def _replicate_spec(tree):
    return jax.tree.map(lambda _: P(), tree)


def sharded_sample_pass(
    mesh: Mesh,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
):
    """Build a jitted SPMD pass: (scene, camera, key) → f32[H, W, 3]
    mean image of ``spp`` samples, sharded P("rays") over rows.

    Requires ``height % rays_shards == 0`` and ``spp % spp_shards == 0``.
    """
    n_rays = mesh.shape[RAYS_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    if height % n_rays:
        raise ValueError(f"height {height} not divisible by rays shards {n_rays}")
    if spp % n_spp:
        raise ValueError(f"spp {spp} not divisible by spp shards {n_spp}")
    rows_local = height // n_rays
    spp_local = spp // n_spp

    axes = (RAYS_AXIS, SPP_AXIS)

    def local_pass(scene: ScenePack, camera: Camera, key: jax.Array):
        ri = jax.lax.axis_index(RAYS_AXIS)
        si = jax.lax.axis_index(SPP_AXIS)
        y0 = ri * rows_local
        dev_key = jax.random.fold_in(key, ri * 65536 + si)

        def one_sample(acc, s):
            img = render_rows(
                scene,
                camera,
                jax.random.fold_in(dev_key, s),
                width,
                height,
                y0,
                rows_local,
                config,
                vary_axes=axes,
            )
            return acc + img, None

        total, _ = jax.lax.scan(
            one_sample,
            # pcast: constants are replicated, the per-sample images are
            # device-varying; the scan carry types must agree for
            # shard_map's check_vma typecheck. Same treatment inside the
            # integrator scans via ``vary_axes``.
            _pcast_missing(
                jnp.zeros((rows_local, width, 3), jnp.float32), axes
            ),
            jnp.arange(spp_local),
        )
        # Combine sample shards: the forward pass's one collective.
        total = jax.lax.psum(total, SPP_AXIS)
        return total / spp

    fn = shard_map(
        local_pass,
        mesh=mesh,
        in_specs=(_replicate_spec_scene(), _replicate_spec_camera(), P()),
        out_specs=P(RAYS_AXIS, None, None),
        # The varying-axes typecheck is ON for every compiled path. The
        # one exception: Pallas INTERPRET mode traces the kernel body as
        # plain jax ops inside the mesh body, where constant-index
        # slices trip the dynamic_slice vma rule (JAX suggests this
        # exact workaround); a compiled pallas_call is opaque to the
        # checker and typechecks through `ops.nearest._sds`.
        check_vma=not config.pallas_interpret,
    )
    return jax.jit(fn)


def sharded_regen_pass(
    mesh: Mesh,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
):
    """SPMD regenerating-wavefront pass (render/regen.py): each device
    runs one persistent wavefront over its row band for its share of
    the samples — the regen loop is embarrassingly parallel (lanes pin
    to pixels, no cross-lane state), so the only collective is the
    same spp-axis psum as `sharded_sample_pass`. Devices drain their
    quotas independently (their `lax.while_loop`s exit per shard).

    Returns a jitted (scene, camera, key) → f32[H, W, 3] mean image
    sharded P("rays") over rows.
    """
    from ..render.regen import render_regen_planar

    n_rays = mesh.shape[RAYS_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    if height % n_rays:
        raise ValueError(
            f"height {height} not divisible by rays shards {n_rays}"
        )
    if spp % n_spp:
        raise ValueError(f"spp {spp} not divisible by spp shards {n_spp}")
    rows_local = height // n_rays
    spp_local = spp // n_spp
    axes = (RAYS_AXIS, SPP_AXIS)

    def local_pass(scene: ScenePack, camera: Camera, key: jax.Array):
        ri = jax.lax.axis_index(RAYS_AXIS)
        si = jax.lax.axis_index(SPP_AXIS)
        dev_key = jax.random.fold_in(key, ri * 65536 + si)
        img = render_regen_planar(
            scene, camera, dev_key, width, height, spp_local, config,
            y0=ri * rows_local, n_rows=rows_local, vary_axes=axes,
        )  # (3, rows_local, W) mean of spp_local samples
        total = jax.lax.psum(img * spp_local, SPP_AXIS)
        return (total / spp).transpose(1, 2, 0)

    fn = shard_map(
        local_pass,
        mesh=mesh,
        in_specs=(_replicate_spec_scene(), _replicate_spec_camera(), P()),
        out_specs=P(RAYS_AXIS, None, None),
        check_vma=not config.pallas_interpret,
    )
    return jax.jit(fn)


def _replicate_spec_scene():
    # Scene/BVH replicated per chip (BASELINE.json): a P() prefix spec.
    return P()


def _replicate_spec_camera():
    return P()


def film_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for the film color: rows over the rays axis."""
    return NamedSharding(mesh, P(RAYS_AXIS, None, None))


def make_progressive_step(
    mesh: Mesh,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
):
    """Jitted progressive step: (scene, camera, film, key) → film, with
    the film sharded band-wise across the rays axis."""
    sample_pass = sharded_sample_pass(
        mesh, width=width, height=height, spp=spp, config=config
    )

    @jax.jit
    def step(scene, camera, film: Film, key) -> Film:
        img = sample_pass(scene, camera, key)
        return film_update(film, img, float(spp))

    return step


def make_train_step(
    mesh: Mesh,
    scene: ScenePack,
    camera: Camera,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    lr: float = 0.5,
):
    """Jitted sharded inverse-rendering step.

    Forward: sharded sample pass (film psum over the spp axis).
    Backward: `jax.grad` transposes that psum into the parameter
    gradient all-reduce over the mesh — the reference has no analog
    (single device); this is the BASELINE.json gradient all-reduce
    path.

    Returns ``step(params, target, key) -> (params, loss)``.
    """
    from ..diff.grad import merge_params

    sample_pass = sharded_sample_pass(
        mesh, width=width, height=height, spp=spp, config=config
    )

    def loss_fn(params, target, key):
        s = merge_params(scene, params)
        img = sample_pass(s, camera, key)
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step(params, target, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, target, key)
        new_params = jax.tree.map(lambda p, g: jnp.maximum(p - lr * g, 0.0), params, grads)
        return new_params, loss

    return step


def make_geom_train_step(
    mesh: Mesh,
    scene: ScenePack,
    camera: Camera,
    tri_mask,  # bool[T] triangles that translate with θ
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    n_edge_samples: int = 2048,
    lr: float = 2.0,
):
    """Sharded GEOMETRY-optimization step (BASELINE config 5): recover
    a rigid translation θ ∈ R³ of a marked triangle subset from a
    target image, fully under `shard_map`.

    The interior vertex gradient is exactly zero for this material
    model (diff/grad.py), so dLoss/dθ is the boundary/silhouette term
    (`diff.boundary`). Sharding:

    - the render wavefront is sharded as in `sharded_sample_pass`
      (row bands × spp shards, film psum over the spp axis);
    - each device all-gathers the row bands once (the estimator's
      probe pixels land anywhere in the frame) and computes the SAME
      replicated loss/image-gradient;
    - the boundary estimator's probe rays are sharded too: every
      device traces ``n_edge_samples / n_devices`` independent edge
      samples (its own key fold), and the partial θ-gradients are
      combined with ONE psum over both mesh axes — the gradient
      all-reduce.

    Returns ``step(theta, target, key) -> (theta', loss)``.
    """
    import dataclasses

    import numpy as np

    from ..diff.boundary import boundary_grad_translation, unique_edges

    n_rays = mesh.shape[RAYS_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    n_dev = n_rays * n_spp
    if height % n_rays:
        raise ValueError(f"height {height} not divisible by {n_rays}")
    if spp % n_spp:
        raise ValueError(f"spp {spp} not divisible by {n_spp}")
    if n_edge_samples % n_dev:
        raise ValueError(
            f"n_edge_samples {n_edge_samples} not divisible by {n_dev}"
        )
    rows_local = height // n_rays
    spp_local = spp // n_spp
    n_local = n_edge_samples // n_dev
    axes = (RAYS_AXIS, SPP_AXIS)

    tm = np.asarray(tri_mask)
    vids = np.unique(np.asarray(scene.tri_v)[tm].ravel())
    vmask = np.zeros((scene.vertices.shape[0], 1), np.float32)
    vmask[vids] = 1.0
    vmask = jnp.asarray(vmask)
    edges = jnp.asarray(unique_edges(scene.tri_v, tm))

    def shifted(theta):
        return dataclasses.replace(
            scene, vertices=scene.vertices + vmask * theta[None, :]
        )

    def local_step(theta, target, key):
        ri = jax.lax.axis_index(RAYS_AXIS)
        si = jax.lax.axis_index(SPP_AXIS)
        s = shifted(theta)
        y0 = ri * rows_local
        dev_key = jax.random.fold_in(key, ri * 65536 + si)

        def one_sample(acc, smp):
            img = render_rows(
                s, camera, jax.random.fold_in(dev_key, smp),
                width, height, y0, rows_local, config, vary_axes=axes,
            )
            return acc + img, None

        total, _ = jax.lax.scan(
            one_sample,
            _pcast_missing(
                jnp.zeros((rows_local, width, 3), jnp.float32), axes
            ),
            jnp.arange(spp_local),
        )
        band = jax.lax.psum(total, SPP_AXIS) / spp  # (rows_local, W, 3)
        # Replicated loss: per-band residual psum'd over the rays axis
        # (invariant by construction — no gather needed for the loss).
        tgt_band = jax.lax.dynamic_slice(
            target, (y0, 0, 0), (rows_local, width, 3)
        )
        sq = jnp.sum((band - tgt_band) ** 2)
        loss = jax.lax.psum(sq, RAYS_AXIS) / (height * width * 3)
        # The probes' pixel weights come from anywhere in the frame:
        # one all-gather of the row bands builds the full image grad.
        full_img = jax.lax.all_gather(
            band, RAYS_AXIS, axis=0, tiled=True
        )  # (H, W, 3)
        image_grad = 2.0 * (full_img - target) / (height * width * 3)
        probe_key = jax.random.fold_in(key, 7777 + ri * 65536 + si)
        g_local = boundary_grad_translation(
            s, camera, edges, image_grad, probe_key,
            width=width, height=height, config=config,
            n_samples=n_local, vary_axes=axes,
        )
        # Gradient all-reduce: mean of the devices' independent
        # estimates (each already normalized to its own sample count).
        grad = jax.lax.psum(g_local, axes) / n_dev
        return loss, grad

    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=not config.pallas_interpret,
    )

    @jax.jit
    def step(theta, target, key):
        loss, grad = fn(theta, target, key)
        return theta - lr * grad, loss

    return step
