"""Wavefront path-tracing integrator (SoA layout).

The reference's `sampleMC` is a per-thread sequential bounce loop with
data-dependent exits (CUTracer.cu:98-177, rtx.hlsl:304-371). Here it is
a *wavefront*: all R rays advance one path segment per step of a
`lax.scan` with static trip count; terminated lanes are masked. Russian
roulette becomes a masked kill + 1/p throughput compensation,
preserving the reference estimator exactly.

Layout: all per-ray state is **component-major** — positions,
directions, throughput and results are ``f32[3, R]``, masks are
``[R]`` — so every elementwise op runs over the long ray axis.

Both termination strategies are supported as one scan parameterized by a
static :class:`TraceConfig`:

- ``mode="fixed"`` — CUDA semantics: exactly ``max_depth`` scatter
  bounces, then one extra intersection that collects emission only
  (CUTracer.cu:103-175); emitters scale by ``illum`` (ILLUM=10,
  stdafx.h:45).
- ``mode="rr"`` — HLSL semantics: unbounded-until-miss loop with
  Russian roulette after ``rr_depth`` bounces (survive w.p.
  max(throughput), compensate by 1/p) and a hard kill at
  ``3*rr_depth`` (rtx.hlsl:311-328); no illum scale (rtx.hlsl:332).

Material/lobe semantics shared by both (CUTracer.cu:112-160):
- emitter iff any component of Ka > 0 → return throughput × Ka × illum;
- Tr > 0 → Fresnel refract/reflect; Kd multiplies throughput in the
  CUDA backend but not the HLSL one (rtx.hlsl:345) — ``refract_kd``;
- else Ns > 1 → Phong specular, throughput ×= Ks;
- else diffuse with two-sided normal flip (sample the hemisphere away
  from the incident side), throughput ×= Kd;
- next origin offset: hit + 0.01 × new_dir (CUTracer.cu:134).

Intersector backends (``config.intersector``; `resolve_intersector`
maps ``"auto"`` from the platform):
- ``"nearest"`` — the Pallas Triton kernel picks each ray's winner
  (`ops.nearest`); the GPU path.
- ``"brute"`` — pure lax oracle (CPU-friendly, differentiable).
- ``"kdtree"`` — stackless KD traversal (needs ``accel=KDArrays``).

Each picks the winner only; its hit is recomputed differentiably by one
shared `refine_hit`. A segment is the intersection followed by `segment_epilogue` (RR,
emission, BSDF sampling, state update), which the regenerating
wavefront (`render.regen`) shares with per-lane depth flags.

The scan body is wrapped in `jax.checkpoint`: reverse-mode AD replays
each segment instead of storing the per-segment intersection
intermediates — the path-replay gradient strategy, exact because all
randomness is counter-based (`ops.rng`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..scene.scene import ScenePack
from ..scene.camera import Camera
from ..ops.rng import stream_uniform
from ..ops.sampling import (
    sample_hemi,
    sample_phong,
    sample_phong_reflect,
    sample_fresnel,
    dot3,
    normalize3,
)
from ..ops.intersect import triangle_transforms, intersect_brute
from ..ops.nearest import refine_hit


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static integrator configuration (hashable → usable as a jit
    static argument)."""

    mode: str = "fixed"  # "fixed" (CUDA) or "rr" (HLSL)
    max_depth: int = 7  # scatter bounces in "fixed" mode (CUTracer.cu:212)
    rr_depth: int = 5  # RR start in "rr" mode (rtx.hlsl:400)
    illum: float = 10.0  # emitter scale (ILLUM, stdafx.h:45); 1.0 for HLSL
    eps_offset: float = 0.01  # self-intersection offset (CUTracer.cu:134)
    refract_kd: bool = True  # CUDA multiplies Kd on refract; HLSL doesn't
    t_chunk: int = 0  # triangle chunk for the brute intersector (0 = all)
    ray_chunk: int = 8192  # rays per wavefront tile (bounds the [R, T]
    # intersection intermediate; 0 = whole frame in one wavefront)
    intersector: str = "brute"  # "nearest" | "brute" | "kdtree"
    phong_model: str = "blinn"  # specular sampler: "blinn" = the
    # committed half-vector formulation (Utils.hpp:72-95); "phong" =
    # classic reflection-lobe sampling — the variant MC.docx's
    # Figures 3/4 (result3/result4) compare against.
    remat_segments: object = "outputs"  # per-segment AD memory policy:
    # "outputs" — checkpoint the scan body but save the nearest
    #   kernel's winner index (i32[R] per segment): the backward
    #   replays only the gathers and the elementwise sampling math,
    #   never the kernel. With a lax intersector nothing is named and
    #   it acts as True. Measured on an H100 (PERF.md): as fast as
    #   False, 1.4x faster than True.
    # True — jax.checkpoint the scan body: the backward replays each
    #   segment, intersection included, for minimal memory.
    # False — store every per-segment intermediate.
    pallas_interpret: bool = False  # run the nearest kernel in the
    # Pallas interpreter (CPU tests)

    @property
    def num_segments(self) -> int:
        """Total intersections per path (static scan length)."""
        if self.mode == "fixed":
            return self.max_depth + 1  # + final emission gather
        elif self.mode == "rr":
            return 3 * self.rr_depth + 1  # hard kill boundary
        raise ValueError(f"unknown mode {self.mode!r}")


def resolve_intersector(requested: str, platform: str) -> str:
    """The one place that maps ``"auto"`` to an intersector: the
    Triton ``"nearest"`` kernel on a CUDA GPU at every scene size (on
    an H100 it beat the lax KD walk 9× on the 82k-triangle bunny,
    PERF.md), the lax ``"brute"`` oracle on the CPU (tests and
    rehearsals). Any other platform is an error. An explicit choice is
    returned as is."""
    if requested != "auto":
        return requested
    if platform == "gpu":
        return "nearest"
    if platform == "cpu":
        return "brute"
    raise RuntimeError(f"no intersector for platform {platform!r}")


def _gather_material(scene: ScenePack, tri_id: jnp.ndarray):
    """Per-ray material fields for hit triangles (AoS gathers). Returns
    ka/kd/ks as [R, 3]."""
    tid = jnp.maximum(tri_id, 0)
    mid = scene.tri_mat[tid]
    return dict(
        ka=scene.mat_ka[mid],
        kd=scene.mat_kd[mid],
        ks=scene.mat_ks[mid],
        ns=scene.mat_ns[mid],
        tr=scene.mat_tr[mid],
        ni=scene.mat_ni[mid],
    )


def _interp_normal(n0, n1, n2, beta, gamma):
    """Smooth normal from corner normals [3, R]: barycentric
    interpolation + normalize (CUTracer.cu:122-126)."""
    w0 = (1.0 - beta - gamma)[None, :]
    n = n0 * w0 + n1 * beta[None, :] + n2 * gamma[None, :]
    return normalize3(n)


def _make_intersect_shade(scene: ScenePack, config: TraceConfig, accel):
    """Build ``intersect_shade(pos3, dir3)`` for the configured backend.

    Returns a function producing a dict with [R]-shaped ``tri_id, miss,
    t, beta, gamma, ns, tr, ni`` and [3, R]-shaped ``point, ka, kd, ks,
    n0, n1, n2``. An intersector only picks each ray's winner; XLA then
    recomputes the winner's hit (`ops.nearest.refine_hit`, exact f32 and
    differentiable) and gathers its shading row the same way for all of
    them, so equal winners give bit-equal segments.
    """
    a, b, c = scene.triangle_vertices()
    m, m_a = triangle_transforms(a, b, c)
    sg = jax.lax.stop_gradient

    if config.intersector == "nearest":
        from jax.ad_checkpoint import checkpoint_name

        from ..ops.nearest import nearest_index

        def winner(o, d):
            idx = nearest_index(
                sg(m), sg(m_a), scene.tri_valid, sg(o).T, sg(d).T,
                interpret=config.pallas_interpret,
            )
            if config.remat_segments == "outputs":
                # Saved for the backward by the scan's checkpoint
                # policy: the replay never re-runs the kernel.
                idx = checkpoint_name(idx, "mcpt_seg")
            return idx
    elif config.intersector == "brute":
        t_chunk = config.t_chunk if config.t_chunk > 0 else None

        def winner(o, d):
            return intersect_brute(
                sg(m), sg(m_a), scene.tri_valid, sg(o), sg(d), t_chunk=t_chunk
            ).tri_id
    elif config.intersector == "kdtree":
        if accel is None:
            raise ValueError("intersector='kdtree' requires accel=KDArrays")
        from ..ops.traverse import intersect_kdtree

        def winner(o, d):
            return intersect_kdtree(
                accel, sg(m), sg(m_a), scene.tri_valid, sg(o), sg(d)
            ).tri_id
    else:
        raise ValueError(f"unknown intersector {config.intersector!r}")

    def intersect(o, d):
        return refine_hit(m, m_a, o, d, winner(o, d))

    def intersect_shade(pos3, dir3):
        hit = intersect(pos3.T, dir3.T)
        mat = _gather_material(scene, hit.tri_id)
        tid = jnp.maximum(hit.tri_id, 0)
        return dict(
            tri_id=hit.tri_id,
            miss=hit.tri_id < 0,
            t=hit.t,
            beta=hit.beta,
            gamma=hit.gamma,
            point=hit.point.T,
            n0=scene.normals[scene.tri_n[tid, 0]].T,
            n1=scene.normals[scene.tri_n[tid, 1]].T,
            n2=scene.normals[scene.tri_n[tid, 2]].T,
            ka=mat["ka"].T,
            kd=mat["kd"].T,
            ks=mat["ks"].T,
            ns=mat["ns"],
            tr=mat["tr"],
            ni=mat["ni"],
        )

    return intersect_shade


def segment_flags(config: TraceConfig, depth):
    """Depth predicates of one path segment: ``(final_gather, do_rr,
    hard_kill)`` as bools shaped like ``depth`` — a scalar segment
    index in the scan integrator, an i32[R] row of per-lane depths in
    the regenerating wavefront."""
    if config.mode == "rr":
        # Hard kill at 3*rr_depth bounces (rtx.hlsl:313-316); Russian
        # roulette once past rr_depth (rtx.hlsl:317-328).
        hard_kill = depth >= 3 * config.rr_depth
        do_rr = (depth >= config.rr_depth) & ~hard_kill
        return jnp.zeros_like(hard_kill), do_rr, hard_kill
    final_gather = depth == config.max_depth
    no = jnp.zeros_like(final_gather)
    return final_gather, no, no


def segment_epilogue(
    config: TraceConfig,
    s: dict,
    pos, dir_, throughput, result, active,
    u1, u2, u_rr,
    final_gather, do_rr, hard_kill,
):
    """Everything in a path segment after the intersection: Russian
    roulette, emission, BSDF sampling and the state update. Returns
    ``(new_pos, new_dir, new_throughput, new_result, still)``.

    The flags may be scalars (scan integrator: every lane at the same
    depth) or [R] rows (regenerating wavefront); ``u_rr`` is only read
    in ``"rr"`` mode. XLA fuses this into a few elementwise kernels and
    AD gives its backward."""
    miss = s["miss"]
    is_emit = (s["ka"] > 0.0).any(axis=0)

    if config.mode == "rr":
        p = jnp.max(throughput, axis=0)
        survive = p > u_rr
        rr_dead = do_rr & ~survive
        throughput = jnp.where(
            (do_rr & survive)[None, :],
            throughput / jnp.maximum(p, 1e-20)[None, :],
            throughput,
        )
        dead_now = miss | rr_dead | hard_kill
    else:
        dead_now = miss

    # Emitter hit → terminate with throughput × Ka × illum
    # (CUTracer.cu:112-120); the fixed-mode final-gather segment
    # terminates every surviving hit with Ka×illum
    # (CUTracer.cu:162-175).
    emit_now = active & ~dead_now & (is_emit | final_gather)
    emitted = throughput * s["ka"] * jnp.float32(config.illum)
    result = jnp.where(emit_now[None, :], emitted, result)

    still = active & ~dead_now & ~emit_now

    # --- scatter ---------------------------------------------------------
    normal = _interp_normal(s["n0"], s["n1"], s["n2"], s["beta"], s["gamma"])
    d_fresnel = sample_fresnel(u1, normal, dir_, s["tr"], s["ni"])
    phong_fn = (
        sample_phong_reflect
        if config.phong_model == "phong"
        else sample_phong
    )
    d_phong = phong_fn(u1, u2, normal, dir_, s["ns"])
    d_hemi = sample_hemi(u1, u2, normal)
    # Two-sided diffuse flip (CUTracer.cu:151-158).
    flip = dot3(dir_, normal) > 0.0
    d_diff = jnp.where(flip[None, :], -d_hemi, d_hemi)

    is_fresnel = s["tr"] > 0.0
    is_phong = ~is_fresnel & (s["ns"] > 1.0)
    new_dir = jnp.where(
        is_fresnel[None, :],
        d_fresnel,
        jnp.where(is_phong[None, :], d_phong, d_diff),
    )
    albedo_fresnel = s["kd"] if config.refract_kd else jnp.ones_like(s["kd"])
    albedo = jnp.where(
        is_fresnel[None, :],
        albedo_fresnel,
        jnp.where(is_phong[None, :], s["ks"], s["kd"]),
    )

    new_throughput = jnp.where(still[None, :], throughput * albedo, throughput)
    new_pos = jnp.where(
        still[None, :], s["point"] + new_dir * config.eps_offset, pos
    )
    new_dir = jnp.where(still[None, :], new_dir, dir_)
    return new_pos, new_dir, new_throughput, result, still


def _pcast_missing(x, axes):
    """`jax.lax.pcast(..., to='varying')` only over the manual axes the
    value does not already vary on (pcast rejects varying→varying)."""
    vma = getattr(jax.typeof(x), "vma", frozenset())
    need = tuple(a for a in axes if a not in vma)
    return jax.lax.pcast(x, need, to="varying") if need else x


def trace_radiance_soa(
    scene: ScenePack,
    pos3: jnp.ndarray,  # f32[3, R]
    dir3: jnp.ndarray,  # f32[3, R] unit
    key: jax.Array,
    config: TraceConfig,
    accel=None,
    vary_axes: Tuple[str, ...] = (),
) -> jnp.ndarray:
    """Estimate radiance along R rays. Returns f32[3, R].

    ``vary_axes``: when tracing inside a `shard_map` body, the manual
    mesh axis names this trace varies over. The scan init carries are
    built from constants (replicated), while the scan outputs inherit
    the device-varying type of ``key`` — `jax.lax.pcast`-ing the init
    to the same varying axes is what lets shard_map's `check_vma`
    typecheck pass without disabling it."""
    R = pos3.shape[1]
    intersect_shade = _make_intersect_shade(scene, config, accel)

    def segment(carry, seg_idx):
        pos, dir_, throughput, result, active = carry
        s = intersect_shade(pos, dir_)
        u1 = stream_uniform(key, seg_idx * 4 + 0, (R,))
        u2 = stream_uniform(key, seg_idx * 4 + 1, (R,))
        u_rr = (
            stream_uniform(key, seg_idx * 4 + 3, (R,))
            if config.mode == "rr"
            else None
        )
        out = segment_epilogue(
            config, s, pos, dir_, throughput, result, active, u1, u2, u_rr,
            *segment_flags(config, seg_idx),
        )
        return out, None

    init = (
        pos3,
        dir3,
        jnp.ones((3, R), jnp.float32),
        jnp.zeros((3, R), jnp.float32),
        jnp.ones((R,), bool),
    )
    if vary_axes:
        init = jax.tree.map(lambda x: _pcast_missing(x, vary_axes), init)
    if config.remat_segments == "outputs":
        body = jax.checkpoint(
            segment,
            policy=jax.checkpoint_policies.save_only_these_names(
                "mcpt_seg"
            ),
        )
    elif config.remat_segments:
        body = jax.checkpoint(segment)
    else:
        body = segment
    (_, _, _, result, _), _ = jax.lax.scan(
        body, init, jnp.arange(config.num_segments)
    )
    return result


def trace_radiance(
    scene: ScenePack,
    origins: jnp.ndarray,  # f32[R, 3]
    dirs: jnp.ndarray,  # f32[R, 3] unit
    key: jax.Array,
    config: TraceConfig,
    accel=None,
) -> jnp.ndarray:
    """AoS wrapper over :func:`trace_radiance_soa` (returns f32[R, 3])."""
    return trace_radiance_soa(scene, origins.T, dirs.T, key, config, accel).T


def render_rows_planar(
    scene: ScenePack,
    camera: Camera,
    key: jax.Array,
    width: int,
    height: int,
    y0,
    n_rows: int,
    config: TraceConfig,
    accel=None,
    vary_axes: Tuple[str, ...] = (),
) -> jnp.ndarray:
    """One sample per pixel for rows [y0, y0+n_rows). Returns
    **planar** f32[3, n_rows, W] — the film's internal layout. ``y0``
    may be traced (a mesh axis offset); each device renders its own
    row window (the SPMD building block). ``vary_axes``: see
    :func:`trace_radiance_soa`."""
    R = width * n_rows
    pix = jnp.arange(R)
    xs = pix % width
    ys = pix // width + y0
    # Jitter streams live far above any per-segment stream id.
    jx = stream_uniform(key, 1 << 30, (R,)) * 2.0 - 1.0
    jy = stream_uniform(key, (1 << 30) + 1, (R,)) * 2.0 - 1.0
    pos3, dir3 = camera.generate_rays_soa(xs, ys, jx, jy, width, height)

    rc = config.ray_chunk
    if rc <= 0 or rc >= R:
        radiance = trace_radiance_soa(
            scene, pos3, dir3, key, config, accel, vary_axes
        )
    else:
        # Tile the wavefront to bound the oracle's [rays, tris]
        # intermediate; tiles run sequentially under one jit.
        pad = (-R) % rc
        if pad:
            pos3 = jnp.concatenate([pos3, jnp.zeros((3, pad))], axis=1)
            dpad = jnp.tile(jnp.asarray([[0.0], [0.0], [1.0]], dir3.dtype), (1, pad))
            dir3 = jnp.concatenate([dir3, dpad], axis=1)
        n_tiles = pos3.shape[1] // rc
        pos3 = pos3.reshape(3, n_tiles, rc).transpose(1, 0, 2)
        dir3 = dir3.reshape(3, n_tiles, rc).transpose(1, 0, 2)
        ids = jnp.arange(n_tiles)

        def tile(args):
            p, d, i = args
            return trace_radiance_soa(
                scene, p, d, jax.random.fold_in(key, (1 << 29) + i),
                config, accel, vary_axes,
            )

        radiance = jax.lax.map(tile, (pos3, dir3, ids))  # (n_tiles, 3, rc)
        radiance = radiance.transpose(1, 0, 2).reshape(3, -1)[:, :R]
    return radiance.reshape(3, n_rows, width)


def render_rows(
    scene: ScenePack,
    camera: Camera,
    key: jax.Array,
    width: int,
    height: int,
    y0,
    n_rows: int,
    config: TraceConfig,
    accel=None,
    vary_axes: Tuple[str, ...] = (),
) -> jnp.ndarray:
    """AoS wrapper over :func:`render_rows_planar`: f32[n_rows, W, 3]."""
    return render_rows_planar(
        scene, camera, key, width, height, y0, n_rows, config, accel,
        vary_axes,
    ).transpose(1, 2, 0)


def render_sample_batch(
    scene: ScenePack,
    camera: Camera,
    key: jax.Array,
    width: int,
    height: int,
    config: TraceConfig,
    accel=None,
) -> jnp.ndarray:
    """One sample per pixel over the full frame. Returns f32[H, W, 3].

    Equivalent to one iteration of the reference's per-kernel sample
    loop (CUTracer.cu:193-213): jittered pixel position, pinhole ray,
    one radiance estimate.
    """
    return render_rows(
        scene, camera, key, width, height, 0, height, config, accel
    )


# Jitted entry points (config and frame geometry are static): one XLA
# compilation per configuration instead of eager op-by-op dispatch.
trace_radiance_jit = jax.jit(trace_radiance, static_argnames=("config",))
render_sample_batch_jit = jax.jit(
    render_sample_batch, static_argnames=("width", "height", "config")
)
