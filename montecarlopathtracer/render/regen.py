"""Regenerating-wavefront renderer: dead lanes immediately restart the
next sample — the wavefront answer to persistent-threads path tracing.

Why it exists: the reference's RR loop (rtx.hlsl:311-328) runs per
thread — a warp's threads retire independently and the SM schedules
fresh warps, so dead paths cost (almost) nothing. The static wavefront
scan (`render.integrator.trace_radiance_soa`) instead pays all
``3*rr_depth + 1`` segments at full width while the live fraction
decays from 1.0 to ~0.02.

The regenerating wavefront keeps every lane busy instead: lane ``i``
is pinned to pixel ``i`` and traces that pixel's ``spp`` samples
back-to-back — the step a path terminates (miss / emitter / RR death /
hard kill), its radiance is accumulated into the lane's running sum
and the lane restarts with a fresh camera ray for the pixel's next
sample. One `lax.while_loop` runs segments (intersection +
`integrator.segment_epilogue` with per-lane depth flags) until every
lane has finished its quota; occupancy stays ~100% for the bulk of the
loop and decays only over the final straggler tail. Lane↔pixel pinning
means zero scatters: the film contribution is a plain per-lane reshape.
It runs on every intersector.

Estimator: unbiased and deterministic (counter-based streams,
`ops.rng`), but not pass-exact vs the scan integrator for ``spp > 1``
— a lane's later samples consume the *step's* stream rather than a
per-sample-indexed one (iid either way). For ``spp == 1`` no lane ever
regenerates, every live lane sits at the same depth, and the streams
are indexed identically — the result is bit-identical to the scan
integrator (tested, tests/test_regen.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from typing import Tuple

from ..scene.scene import ScenePack
from ..scene.camera import Camera
from ..ops.rng import stream_uniform
from .integrator import (
    TraceConfig,
    _make_intersect_shade,
    _pcast_missing,
    segment_epilogue,
    segment_flags,
)


def render_regen_planar(
    scene: ScenePack,
    camera: Camera,
    key: jax.Array,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    accel=None,
    y0=0,
    n_rows: int = 0,
    vary_axes: Tuple[str, ...] = (),
) -> jnp.ndarray:
    """Mean radiance over ``spp`` samples/pixel as planar
    f32[3, n_rows, W] for rows [y0, y0+n_rows) (default: whole frame).

    Inference-only (the loop is a `lax.while_loop`);
    gradient renders use the scan integrator. ``y0``/``n_rows``/
    ``vary_axes`` serve the SPMD row-band decomposition
    (`parallel.sharded.sharded_regen_pass`): lanes pin to the band's
    pixels and the loop init is pcast to the mesh axes the trace
    varies over (see `trace_radiance_soa`)."""
    if not n_rows:
        n_rows = height
    R = width * n_rows
    intersect_shade = _make_intersect_shade(scene, config, accel)
    lanes = jnp.arange(R)
    xs = lanes % width
    ys = lanes // width + y0
    n_seg = config.num_segments

    def draw_seg(step, k):
        # Stream ids match the scan integrator's ``seg_idx * 4 + k``
        # with seg_idx = step - 1: at spp=1 every live lane's depth
        # equals step - 1, so the whole render replays the scan
        # integrator's exact draws (the bit-equality test hook).
        return stream_uniform(key, (step - 1) * 4 + k, (R,))

    def camera_rays(step):
        # Jitter streams live in the same >=2^30 region as the scan
        # path's; step 0 (the initial wavefront) uses its exact ids.
        base = (1 << 30) + step * 2
        jx = stream_uniform(key, base, (R,)) * 2.0 - 1.0
        jy = stream_uniform(key, base + 1, (R,)) * 2.0 - 1.0
        return camera.generate_rays_soa(xs, ys, jx, jy, width, height)

    pos0, dir0 = camera_rays(jnp.int32(0))
    zero3 = jnp.zeros((3, R), jnp.float32)
    init = (
        pos0,
        dir0,
        jnp.ones((3, R), jnp.float32),  # throughput
        zero3,  # per-path result
        zero3,  # per-lane radiance sum over completed samples
        jnp.ones((R,), bool),  # live
        jnp.zeros((R,), jnp.int32),  # depth within current path
        jnp.zeros((R,), jnp.int32),  # samples completed
        jnp.int32(1),  # step (1-based: segment at depth step-1 @ spp=1)
    )
    if vary_axes:
        init = jax.tree.map(lambda x: _pcast_missing(x, vary_axes), init)
    # Every path runs at most n_seg segments (hard kill / final
    # gather), so spp samples need at most spp * n_seg steps; the
    # bound is a backstop — `live` empties first.
    max_steps = spp * n_seg + 1

    def cond(c):
        return jnp.any(c[5]) & (c[8] < max_steps)

    def body(c):
        pos, dir_, throughput, res, accum, live, depth, sidx, step = c
        s = intersect_shade(pos, dir_)
        u1 = draw_seg(step, 0)
        u2 = draw_seg(step, 1)
        urr = draw_seg(step, 3) if config.mode == "rr" else None
        npos, ndir, nthroughput, nres, still = segment_epilogue(
            config, s, pos, dir_, throughput, res, live, u1, u2, urr,
            *segment_flags(config, depth),
        )
        ended = live & ~still
        accum = accum + jnp.where(ended[None, :], nres, 0.0)
        regen = ended & (sidx + 1 < spp)
        live = (live & still) | regen
        sidx = sidx + ended.astype(jnp.int32)
        depth = jnp.where(regen, 0, depth + 1)

        posr, dirr = camera_rays(step)
        rg = regen[None, :]
        pos = jnp.where(rg, posr, npos)
        dir_ = jnp.where(rg, dirr, ndir)
        throughput = jnp.where(rg, 1.0, nthroughput)
        res = jnp.where(rg, 0.0, nres)
        return (pos, dir_, throughput, res, accum, live, depth, sidx,
                step + 1)

    final = jax.lax.while_loop(cond, body, init)
    accum = final[4]
    return accum.reshape(3, n_rows, width) / jnp.float32(spp)


def render_regen_batch(
    scene: ScenePack,
    camera: Camera,
    key: jax.Array,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    accel=None,
) -> jnp.ndarray:
    """AoS wrapper over :func:`render_regen_planar`: f32[H, W, 3]."""
    return render_regen_planar(
        scene, camera, key, width, height, spp, config, accel
    ).transpose(1, 2, 0)
