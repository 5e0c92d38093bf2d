"""Secondary-edge (shadow) boundary gradients (r5, VERDICT r4 #8).

The decisive scenario: geometry that is visible ONLY through its
shadow. The blocker sits ABOVE a downward-looking camera, so neither
the interior gradient (exactly zero for this material model) nor the
primary camera-edge estimator can see it move — the entire dLoss/dθ is
the one-bounce shadow boundary term, validated here against a central
finite difference of the rendered loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from montecarlopathtracer.models.cornell import _Builder
from montecarlopathtracer.scene.camera import Camera
from montecarlopathtracer.scene.scene import scene_pack_from_model
from montecarlopathtracer.render.integrator import (
    TraceConfig,
    render_sample_batch_jit,
)
from montecarlopathtracer.diff.boundary import (
    boundary_grad_translation,
    shadow_boundary_grad_translation,
    unique_edges,
)

W = H = 40
CFG = TraceConfig(mode="fixed", max_depth=2, ray_chunk=0)


def _scene(blocker_dx=0.0):
    """Floor + out-of-view blocker + lamp; camera between floor and
    blocker looking straight down (the blocker is behind the camera)."""
    b = _Builder()
    white = b.add_material("white", Kd=(0.8, 0.8, 0.8))
    dark = b.add_material("dark", Kd=(0.2, 0.2, 0.2))
    light = b.add_material("light", Ka=(1.0, 1.0, 1.0))
    # floor at y=0
    s = 6.0
    b.add_quad("floor", white, (-s, 0, -s), (-s, 0, s), (s, 0, s),
               (s, 0, -s), (0, 1, 0))
    # blocker: small quad at y=3, shifted by blocker_dx
    c, hw = blocker_dx, 0.5
    b.add_quad("blocker", dark,
               (c - hw, 3, -hw), (c - hw, 3, hw), (c + hw, 3, hw),
               (c + hw, 3, -hw), (0, -1, 0))
    # lamp: 2×2 downward emitter at y=4.5 (large: decent lamp-hit
    # probability under cosine sampling without NEE)
    b.add_quad("lamp", light, (-1, 4.5, -1), (1, 4.5, -1),
               (1, 4.5, 1), (-1, 4.5, 1), (0, -1, 0))
    pack = scene_pack_from_model(b.model)
    cam = Camera.look(
        (0.0, 2.2, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0),
        width=W, height=H,
    )
    # The pack orders triangles by group, not model order — select the
    # blocker by its (unique) material: Kd = 0.2.
    kd = np.asarray(pack.mat_kd)
    dark_mid = int(np.where(np.isclose(kd[:, 0], 0.2))[0][0])
    tri_mask = (
        np.asarray(pack.tri_mat) == dark_mid
    ) & np.asarray(pack.tri_valid)
    assert tri_mask.sum() == 2
    return pack, cam, tri_mask


def _render(scene, cam, key, spp=24):
    acc = jnp.zeros((H, W, 3))
    for i in range(spp):
        acc = acc + render_sample_batch_jit(
            scene, cam, jax.random.fold_in(key, i),
            width=W, height=H, config=CFG,
        )
    return acc / spp


def test_blocker_is_invisible_and_shadow_is_visible():
    scene, cam, _ = _scene()
    img = np.asarray(_render(scene, cam, jax.random.key(0), spp=32))
    center = img[H // 2 - 4 : H // 2 + 4, W // 2 - 4 : W // 2 + 4].mean()
    # blocker far away → no shadow, same keys: the only difference is
    # the shadow (the camera never sees the blocker itself).
    scene_far, cam2, _ = _scene(100.0)
    img2 = np.asarray(_render(scene_far, cam2, jax.random.key(0), spp=32))
    c2 = img2[H // 2 - 4 : H // 2 + 4, W // 2 - 4 : W // 2 + 4].mean()
    assert center < 0.8 * c2, (center, c2)


def test_shadow_boundary_grad_matches_finite_difference():
    """FD match for a LINEAR loss with a fixed weight image (an
    x-ramp): dLoss/dtheta is then exactly sum(w * dE[I]/dtheta), so the
    FD across independent keys is an unbiased, low-noise reference —
    an MSE-against-rendered-target loss would put MC noise and
    path-correlation bias into the FD itself."""
    xx = jnp.linspace(0, 1, W)[None, :, None]
    wimg = jnp.broadcast_to(xx, (H, W, 3)).astype(jnp.float32)
    image_grad = wimg / (H * W * 3)

    scene, cam, tri_mask = _scene(0.0)
    edges = jnp.asarray(unique_edges(scene.tri_v, tri_mask))

    # The PRIMARY estimator must see exactly nothing: every blocker
    # vertex projects behind the downward camera.
    g_prim = boundary_grad_translation(
        scene, cam, edges, image_grad, jax.random.key(3),
        width=W, height=H, config=CFG, n_samples=4096,
    )
    assert float(jnp.abs(g_prim).max()) == 0.0

    vals = [
        float(
            shadow_boundary_grad_translation(
                scene, cam, edges, image_grad, jax.random.key(50 + k),
                width=W, height=H, config=CFG, n_samples=32768,
            )[0]
        )
        for k in range(3)
    ]
    gx = float(np.mean(vals))

    def loss_of(dx, key):
        s, c2, _ = _scene(dx)
        return float(jnp.mean(wimg * _render(s, c2, key, spp=16)))

    h = 0.15
    fds = [
        (loss_of(h, jax.random.key(900 + k))
         - loss_of(-h, jax.random.key(900 + k))) / (2 * h)
        for k in range(4)
    ]
    fd = float(np.mean(fds))
    # Moving the blocker +x moves the shadow +x into the higher-weight
    # half -> loss decreases: both must be negative and agree.
    assert fd < 0.0 and gx < 0.0, (gx, fd)
    assert abs(gx - fd) < 0.3 * abs(fd), (gx, fd, vals, fds)


def test_shadow_grad_descends_to_target():
    """SGD with the shadow estimator alone recovers the blocker shift
    — geometry optimization through pure shadow visibility."""
    target = _render(*_scene(0.3)[:2], jax.random.key(123), spp=32)
    th = 0.0
    hist = []
    for it in range(10):
        s, cam, tri_mask = _scene(th)
        img = _render(s, cam, jax.random.key(200 + it), spp=16)
        image_grad = 2.0 * (img - target) / img.size
        edges = jnp.asarray(unique_edges(s.tri_v, tri_mask))
        g = shadow_boundary_grad_translation(
            s, cam, edges, image_grad, jax.random.key(300 + it),
            width=W, height=H, config=CFG, n_samples=8192,
        )
        # Robbins-Monro decay: the gradient is a noisy MC estimate, so
        # a fixed step oscillates about the optimum; judge the tail
        # average (standard SA practice).
        th = th - 20.0 / (1.0 + 0.7 * it) * float(g[0])
        hist.append(th)
    final = float(np.mean(hist[-4:]))
    assert abs(final - 0.3) < 0.12, (final, hist)
