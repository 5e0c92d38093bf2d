"""Boundary (visibility/silhouette) gradients via edge sampling.

With the reference's material model every geometric factor cancels
against its importance sampler, so path radiance is piecewise CONSTANT
in vertex positions: the interior (reparameterized) vertex gradient is
exactly zero (`diff.grad` module docstring). All geometry gradient
lives in visibility discontinuities. This module estimates that
boundary term for *primary* visibility with the edge-sampling estimator
of differentiable rasterization/path-tracing (Li et al. 2018 style,
restricted to camera edges), specialized to a rigid translation θ ∈ R³
of a marked triangle subset — enough for BASELINE config 5's "geometry
optimization: recover an object translation from a target image".

Estimator. For pixel value I_p (box filter over the pixel), a visible
edge crossing the pixel at screen position s with unit screen normal n̂
separates radiance L⁻ (the −n̂ side) from L⁺. If translating the
geometry by unit θ_k moves the edge's screen point with velocity v_k,
the boundary derivative is

    dI_p/dθ_k = Σ_edges ∫_pixel (L⁻(s) − L⁺(s)) · (v_k(s)·n̂(s)) dl

and dLoss/dθ_k = Σ_p (dLoss/dI_p) · dI_p/dθ_k. We Monte-Carlo the edge
integral: sample points on the marked mesh's edges ∝ projected screen
length, probe L∓ by tracing two rays through s ∓ ε·n̂, and weight by
the loss's image gradient at the containing pixel. Non-silhouette and
occluded edge samples self-cancel (both probes see the same surface →
L⁻ ≈ L⁺), so no explicit silhouette test is needed; interior mesh
edges are deduped so closed-surface silhouettes aren't double-counted.

Array shape: everything is one vectorized wavefront — E edges projected
in parallel, N edge samples in parallel, 2N probe rays traced by the
ordinary `trace_radiance_soa` wavefront. No per-edge control flow.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..scene.scene import ScenePack
from ..scene.camera import Camera
from ..render.integrator import TraceConfig, trace_radiance_soa
from ..ops.rng import stream_uniform


def unique_edges(tri_v: np.ndarray, tri_mask: np.ndarray) -> np.ndarray:
    """Host-side: unique undirected edges (i32[E, 2]) of the masked
    triangles. Dedupe matters: a closed mesh shares every edge between
    two faces — sampling it twice would double the silhouette term."""
    tv = np.asarray(tri_v)[np.asarray(tri_mask)]
    e = np.concatenate([tv[:, [0, 1]], tv[:, [1, 2]], tv[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0).astype(np.int32)


def _project(camera: Camera, p: jnp.ndarray, width: int, height: int):
    """World point [3, N] → continuous pixel coordinates (sx, sy) plus
    the forward depth (for behind-camera rejection). Inverse of
    `Camera.generate_rays_soa`'s pixel→direction map."""
    d = p - camera.eye[:, None]
    df = jnp.sum(d * camera.forward[:, None], axis=0)
    safe = jnp.where(jnp.abs(df) < 1e-8, 1.0, df)
    xc = jnp.sum(d * camera.right[:, None], axis=0) / safe / camera.tan_half_x
    yc = jnp.sum(d * camera.up[:, None], axis=0) / safe / camera.tan_half_y
    sx = (xc + 1.0) * 0.5 * width
    sy = (1.0 - yc) * 0.5 * height
    return sx, sy, df


def boundary_grad_translation(
    scene: ScenePack,
    camera: Camera,
    edges: jnp.ndarray,  # i32[E, 2] vertex-index pairs (unique_edges)
    image_grad: jnp.ndarray,  # f32[H, W, 3] = dLoss/dI
    key: jax.Array,
    *,
    width: int,
    height: int,
    config: TraceConfig,
    n_samples: int = 4096,
    eps_px: float = 0.3,
    accel=None,
    vary_axes: Tuple[str, ...] = (),
) -> jnp.ndarray:
    """dLoss/dθ (f32[3]) for a unit translation θ of the edge mesh.

    ``image_grad`` is the loss's gradient w.r.t. the rendered image
    (e.g. 2(I−T)/(H·W·3) for mean-squared error), rendered/evaluated by
    the caller. ``eps_px`` is the probe offset in pixels: small enough
    to stay inside the pixel, large enough that the two probe rays
    straddle the edge despite fp projection error.

    Implemented as the row-sum of :func:`boundary_grad_vertices`: the
    estimator is linear in the vertex velocity field, and a rigid
    translation gives every vertex the same unit velocity.
    """
    gv = boundary_grad_vertices(
        scene, camera, edges, image_grad, key,
        width=width, height=height, config=config,
        n_samples=n_samples, eps_px=eps_px, accel=accel,
        vary_axes=vary_axes,
    )
    return jnp.sum(gv, axis=0)


def boundary_grad_vertices(
    scene: ScenePack,
    camera: Camera,
    edges: jnp.ndarray,  # i32[E, 2] vertex-index pairs (unique_edges)
    image_grad: jnp.ndarray,  # f32[H, W, 3] = dLoss/dI
    key: jax.Array,
    *,
    width: int,
    height: int,
    config: TraceConfig,
    n_samples: int = 4096,
    eps_px: float = 0.3,
    accel=None,
    vary_axes: Tuple[str, ...] = (),
) -> jnp.ndarray:
    """Per-vertex boundary gradient dLoss/dvertices (f32[V, 3]).

    ``vary_axes``: mesh axis names when called inside a `shard_map`
    body (each device then traces its own independent probe batch —
    see `parallel.sharded.make_geom_train_step`); threaded to
    `trace_radiance_soa` for the check_vma typecheck.

    Generalizes :func:`boundary_grad_translation` from a rigid θ ∈ R³
    to arbitrary vertex velocities: an edge sample at parameter u on
    edge (i0, i1) moves with world velocity (1−u)·v̇_{i0} + u·v̇_{i1},
    so each sample's screen-velocity term scatters into its two
    endpoint vertices with barycentric weights — two `scatter_add`s,
    no per-vertex loops. Vertices not on any sampled edge get exactly
    zero (matching the zero interior gradient of this material model).

    Identity used by the tests: summing rows of the result over the
    mesh's vertices equals `boundary_grad_translation` (the estimator
    is linear in the velocity field and a translation moves every
    vertex with the same unit velocity).
    """
    E = edges.shape[0]
    V = scene.vertices.shape[0]
    v = scene.vertices.T  # [3, V]
    p0 = v[:, edges[:, 0]]  # [3, E]
    p1 = v[:, edges[:, 1]]

    x0, y0, z0 = _project(camera, p0, width, height)
    x1, y1, z1 = _project(camera, p1, width, height)
    seg_len = jnp.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2)
    vis = (z0 > 1e-6) & (z1 > 1e-6)
    wgt = jnp.where(vis, seg_len, 0.0)
    total_len = jnp.sum(wgt)
    cdf = jnp.cumsum(wgt) / jnp.maximum(total_len, 1e-20)

    u_pick = stream_uniform(key, 11, (n_samples,))
    u_along = stream_uniform(key, 12, (n_samples,))
    eidx = jnp.searchsorted(cdf, u_pick).astype(jnp.int32)
    eidx = jnp.clip(eidx, 0, E - 1)

    sx0, sy0 = x0[eidx], y0[eidx]
    sx1, sy1 = x1[eidx], y1[eidx]
    sx = sx0 + (sx1 - sx0) * u_along
    sy = sy0 + (sy1 - sy0) * u_along
    tx, ty = sx1 - sx0, sy1 - sy0
    tlen = jnp.sqrt(tx * tx + ty * ty)
    safe_t = jnp.maximum(tlen, 1e-12)
    nx, ny = -ty / safe_t, tx / safe_t

    zeros = jnp.zeros((2 * n_samples,))
    xs = jnp.concatenate([sx + eps_px * nx, sx - eps_px * nx])
    ys = jnp.concatenate([sy + eps_px * ny, sy - eps_px * ny])
    pos3, dir3 = camera.generate_rays_soa(xs, ys, zeros, zeros, width, height)
    rad = trace_radiance_soa(
        scene, pos3, dir3, jax.random.fold_in(key, 13), config, accel,
        vary_axes,
    )
    l_plus = rad[:, :n_samples]
    l_minus = rad[:, n_samples:]

    p3 = p0[:, eidx] + (p1[:, eidx] - p0[:, eidx]) * u_along[None, :]

    def proj_xy(q):
        a, b, _ = _project(camera, q, width, height)
        return jnp.stack([a, b])

    px = jnp.clip(jnp.floor(sx).astype(jnp.int32), 0, width - 1)
    py = jnp.clip(jnp.floor(sy).astype(jnp.int32), 0, height - 1)
    wpix = image_grad[py, px, :].T  # [3, N]
    scal = jnp.sum(wpix * (l_minus - l_plus), axis=0)  # [N]
    valid = (tlen > 1e-9) & vis[eidx]
    scal = jnp.where(valid, scal, 0.0)

    # Per-axis screen velocity of the sample under a unit world
    # displacement (jvp is linear in the velocity, so the barycentric
    # factor scales it afterwards).
    per_axis = []
    for k in range(3):
        ek = jnp.zeros((3, 1)).at[k, 0].set(1.0)
        _, dv = jax.jvp(proj_xy, (p3,), (jnp.broadcast_to(ek, p3.shape),))
        v_dot_n = dv[0] * nx + dv[1] * ny  # [N]
        per_axis.append(scal * v_dot_n * total_len / n_samples)
    contrib = jnp.stack(per_axis, axis=1)  # [N, 3]

    i0 = edges[eidx, 0]
    i1 = edges[eidx, 1]
    out = jnp.zeros((V, 3), jnp.float32)
    out = out.at[i0].add(contrib * (1.0 - u_along)[:, None])
    out = out.at[i1].add(contrib * u_along[:, None])
    return out


def shadow_boundary_grad_vertices(
    scene: ScenePack,
    camera: Camera,
    edges: jnp.ndarray,  # i32[E, 2] vertex-index pairs (unique_edges)
    image_grad: jnp.ndarray,  # f32[H, W, 3] = dLoss/dI
    key: jax.Array,
    *,
    width: int,
    height: int,
    config: TraceConfig,
    n_samples: int = 4096,
    eps_ang: float = 1e-3,
    accel=None,
    vary_axes: Tuple[str, ...] = (),
) -> jnp.ndarray:
    """Per-vertex SECONDARY-edge (shadow) boundary gradient — the
    one-bounce visibility term the primary estimator above cannot see
    (r5; the framework north star past camera-silhouette gradients).

    The one-bounce pixel integral is I_p = ∫ ρ(x, ω) L_in(x, ω) dω at
    the primary hit x, with ρ = albedo·cosθ/π for the reference's
    diffuse lobe (cosine importance sampling, CUTracer.cu:146-160).
    L_in(x, ·) is discontinuous across the spherical image of every
    silhouette edge of a blocker: when the blocker moves, the shadow
    moves, and all of that gradient is a boundary term even though the
    blocker may be entirely OUTSIDE the camera frustum. Edge-sampling
    form (Li et al. 2018, restricted to the first bounce):

        dI_p/dθ_k = Σ_edges ∫ ρ(x, ω_e) (L⁻ − L⁺)(x, ω_e)
                         (v_k·n̂)(ω_e) |dω_e/dl| dl

    with ω_e the direction from x to the edge point, n̂ the spherical
    normal of the edge image (⊥ ω_e, ⊥ the edge tangent image), and,
    for a unit world translation e_k of the edge, the spherical
    velocity v_k·n̂ = n̂_k / dist.

    Monte Carlo over (receiver pixel, edge point): sample a uniform
    screen position (→ primary hit via the configured intersector), an
    edge point ∝ world length, probe L∓ by tracing the FULL remaining
    path from x along normalize(ω ∓ eps_ang·n̂) (depth reduced by the
    one camera bounce), and weight by the loss's image gradient at the
    containing pixel. Non-silhouette and unoccluded samples
    self-cancel (both probes see the same radiance) exactly as in the
    primary estimator. Receivers that are emitters / specular /
    transmissive get zero weight (their boundary terms ride specular
    paths — out of scope, documented).

    Sample contributions scatter into the two edge-endpoint vertices
    with barycentric weights, so `shadow_boundary_grad_translation` is
    the row sum (linearity in the velocity field)."""
    import dataclasses

    from ..render.integrator import _make_intersect_shade, _interp_normal

    E = edges.shape[0]
    V = scene.vertices.shape[0]
    n = n_samples
    v = scene.vertices.T  # [3, V]
    p0 = v[:, edges[:, 0]]  # [3, E]
    p1 = v[:, edges[:, 1]]
    elen = jnp.sqrt(jnp.sum((p1 - p0) ** 2, axis=0))
    total_len = jnp.sum(elen)
    cdf = jnp.cumsum(elen) / jnp.maximum(total_len, 1e-20)

    # Receiver: one primary hit per sample at a uniform screen point.
    ux = stream_uniform(key, 31, (n,))
    uy = stream_uniform(key, 32, (n,))
    xs = ux * width
    ys = uy * height
    zeros = jnp.zeros((n,))
    cpos, cdir = camera.generate_rays_soa(xs, ys, zeros, zeros, width, height)
    intersect_shade = _make_intersect_shade(scene, config, accel)
    s = intersect_shade(cpos, cdir)
    hit = ~s["miss"]
    is_emit = (s["ka"] > 0.0).any(axis=0)
    receiver = hit & ~is_emit & ~(s["tr"] > 0.0) & ~(s["ns"] > 1.0)
    x = s["point"]  # [3, n]
    normal = _interp_normal(s["n0"], s["n1"], s["n2"], s["beta"], s["gamma"])
    flip = jnp.sum(cdir * normal, axis=0) > 0.0  # two-sided diffuse
    n_eff = jnp.where(flip[None, :], -normal, normal)
    albedo = s["kd"]  # [3, n]

    # Edge point ∝ world length.
    u_pick = stream_uniform(key, 33, (n,))
    u_along = stream_uniform(key, 34, (n,))
    eidx = jnp.clip(
        jnp.searchsorted(cdf, u_pick).astype(jnp.int32), 0, E - 1
    )
    q0 = p0[:, eidx]
    q1 = p1[:, eidx]
    pe = q0 + (q1 - q0) * u_along[None, :]
    dvec = pe - x
    dist = jnp.sqrt(jnp.sum(dvec * dvec, axis=0))
    safe_d = jnp.maximum(dist, 1e-9)
    omega = dvec / safe_d[None, :]
    lvec = q1 - q0
    lhat = lvec / jnp.maximum(
        jnp.sqrt(jnp.sum(lvec * lvec, axis=0)), 1e-12
    )[None, :]
    # Spherical tangent of the edge image (per arc length) and its
    # in-sphere normal.
    tang = lhat - omega * jnp.sum(omega * lhat, axis=0)[None, :]
    tlen = jnp.sqrt(jnp.sum(tang * tang, axis=0))
    m = tlen / safe_d  # |dω/dl|
    nhat = jnp.stack(
        [
            omega[1] * tang[2] - omega[2] * tang[1],
            omega[2] * tang[0] - omega[0] * tang[2],
            omega[0] * tang[1] - omega[1] * tang[0],
        ]
    ) / jnp.maximum(tlen, 1e-12)[None, :]

    cosw = jnp.sum(omega * n_eff, axis=0)
    front = cosw > 0.0
    rho = albedo * (cosw / jnp.pi)[None, :]  # [3, n]

    # Probe the two sides of the edge image with the full remaining
    # path (the camera bounce used one scatter).
    cfg2 = dataclasses.replace(
        config, max_depth=max(config.max_depth - 1, 1)
    )
    d_plus = omega + eps_ang * nhat
    d_plus = d_plus / jnp.sqrt(jnp.sum(d_plus * d_plus, axis=0))[None, :]
    d_minus = omega - eps_ang * nhat
    d_minus = d_minus / jnp.sqrt(jnp.sum(d_minus * d_minus, axis=0))[None, :]
    posP = jnp.concatenate(
        [x + d_plus * config.eps_offset, x + d_minus * config.eps_offset],
        axis=1,
    )
    dirP = jnp.concatenate([d_plus, d_minus], axis=1)
    rad = trace_radiance_soa(
        scene, posP, dirP, jax.random.fold_in(key, 35), cfg2, accel,
        vary_axes,
    )
    delta_l = rad[:, n:] - rad[:, :n]  # L⁻ − L⁺

    px = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, width - 1)
    py = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, height - 1)
    wpix = image_grad[py, px, :].T  # [3, n]
    scal = jnp.sum(wpix * rho * delta_l, axis=0)  # [n]
    valid = receiver & front & (dist > 1e-6) & (tlen > 1e-9)
    scal = jnp.where(valid, scal, 0.0)

    # v_k·n̂ = n̂_k / dist; one factor of the sampling measure each for
    # the screen (W·H / n uniform pixels-area) and the edge length.
    norm_f = total_len * (width * height) / n
    contrib = (
        scal * m / safe_d * norm_f
    )[:, None] * nhat.T  # [n, 3]

    i0 = edges[eidx, 0]
    i1 = edges[eidx, 1]
    out = jnp.zeros((V, 3), jnp.float32)
    out = out.at[i0].add(contrib * (1.0 - u_along)[:, None])
    out = out.at[i1].add(contrib * u_along[:, None])
    return out


def shadow_boundary_grad_translation(
    scene, camera, edges, image_grad, key, *,
    width, height, config, n_samples: int = 4096,
    eps_ang: float = 1e-3, accel=None, vary_axes=(),
) -> jnp.ndarray:
    """dLoss/dθ (f32[3]) of the one-bounce shadow boundary term for a
    rigid translation of the edge mesh (row sum of
    :func:`shadow_boundary_grad_vertices`)."""
    gv = shadow_boundary_grad_vertices(
        scene, camera, edges, image_grad, key,
        width=width, height=height, config=config,
        n_samples=n_samples, eps_ang=eps_ang, accel=accel,
        vary_axes=vary_axes,
    )
    return jnp.sum(gv, axis=0)


def make_translation_problem(
    scene: ScenePack,
    camera: Camera,
    tri_mask: np.ndarray,  # bool[T] triangles that translate with θ
    target: jnp.ndarray,  # f32[H, W, 3]
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    n_edge_samples: int = 4096,
):
    """Loss + gradient closure for recovering a rigid translation θ.

    Returns ``step(theta, key) -> (loss, grad3)``: renders the scene
    with the masked triangles' vertices shifted by θ, computes the
    mean-squared pixel loss against ``target``, and estimates dLoss/dθ
    with the boundary estimator (the interior term is exactly zero for
    this material model). Jitted end-to-end.
    """
    tm = np.asarray(tri_mask)
    vids = np.unique(np.asarray(scene.tri_v)[tm].ravel())
    vmask = np.zeros((scene.vertices.shape[0], 1), np.float32)
    vmask[vids] = 1.0
    vmask = jnp.asarray(vmask)
    edges = jnp.asarray(unique_edges(scene.tri_v, tm))

    from ..render.integrator import render_sample_batch
    import dataclasses

    def shifted(theta):
        return dataclasses.replace(
            scene, vertices=scene.vertices + vmask * theta[None, :]
        )

    @jax.jit
    def step(theta, key):
        s = shifted(theta)

        def one(acc, i):
            img = render_sample_batch(
                s, camera, jax.random.fold_in(key, i), width, height, config
            )
            return acc + img, None

        total, _ = jax.lax.scan(
            one, jnp.zeros((height, width, 3)), jnp.arange(spp)
        )
        img = total / spp
        loss = jnp.mean((img - target) ** 2)
        image_grad = 2.0 * (img - target) / (height * width * 3)
        grad = boundary_grad_translation(
            s,
            camera,
            edges,
            image_grad,
            jax.random.fold_in(key, 99),
            width=width,
            height=height,
            config=config,
            n_samples=n_edge_samples,
        )
        return loss, grad

    return step
