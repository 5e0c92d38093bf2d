"""On-card smoke test: the path tracer's main paths, once, on a CUDA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded phase only

Phases (each prints its own line; any failure raises and exits non-zero):

1. card — name and power limit from ``nvidia-smi``, read by a child that
   stays off JAX;
2. gpu tests — ``pytest -m gpu`` in a child, before this process first
   touches the card (one JAX process per card);
3. device — JAX's platform, device kind and count; anything but a GPU
   stops here;
4. kernel vs oracle — the Triton nearest kernel against
   ``intersect_brute`` at HIGHEST precision on the Cornell box's
   primary and second-bounce wavefronts at 800×600, and on 64k primary
   rays of the 82k-triangle bunny at 1024², with a float64 oracle as
   the judge of disputed rays;
5. renders through ``cli.main`` — Cornell box at 800×600 with the
   nearest kernel and with ``--intersector brute`` (films compared,
   every differing pixel traced to a differing winner), an RR render
   with the regenerating wavefront, one bunny pass at 1024²;
6. gradient — ``value_and_grad`` of ``make_loss_fn`` with both
   intersectors at one key, then three ``make_sgd_step`` steps toward a
   target rendered from known albedos.

``--four`` runs ``make_progressive_step`` on 4×1 and 2×2 meshes against
the same row bands rendered one after another on one card, and one
``make_geom_train_step``. The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 800, 600
BUNNY = 1024
# Winners of two f32 pipelines may differ only on rays that graze a
# triangle edge; the share of such rays is bounded, and a float64
# oracle measures how exact each side is (`compare_winners`).
MAX_DIFF_SHARE = 1e-4
NEAR_TIE = 1e-4  # |Δt| ≤ NEAR_TIE·t
EDGE = 1e-4  # barycentric distance to an edge that counts as grazing


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reports no card")
    return out


def run_gpu_tests():
    env = dict(os.environ, MCPT_TEST_ON_GPU="1")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if r.returncode != 0 or " passed" not in tail or "skipped" in tail:
        raise RuntimeError(
            f"gpu tests failed (rc={r.returncode}):\n{r.stdout[-3000:]}"
            f"\n{r.stderr[-2000:]}"
        )
    return tail


# -- phase 4: kernel vs oracle ----------------------------------------------


def primary_rays(camera, width, height, stride=1):
    import jax.numpy as jnp

    pix = jnp.arange(0, width * height, stride)
    z = jnp.zeros(pix.shape, jnp.float32)
    return camera.generate_rays_soa(pix % width, pix // width, z, z,
                                    width, height)


def bounce_rays(scene, pos3, dir3, seed=1):
    """The second-bounce wavefront: one full segment (oracle hit, BSDF
    sampling) from the primary rays; dead lanes keep their ray."""
    import jax

    from montecarlopathtracer.ops.rng import stream_uniform
    from montecarlopathtracer.render.integrator import (
        TraceConfig, _make_intersect_shade, segment_epilogue, segment_flags,
    )

    cfg = TraceConfig(intersector="brute")
    R = pos3.shape[1]
    key = jax.random.key(seed)
    s = _make_intersect_shade(scene, cfg, None)(pos3, dir3)
    import jax.numpy as jnp

    npos, ndir, _, _, _ = segment_epilogue(
        cfg, s, pos3, dir3, jnp.ones((3, R)), jnp.zeros((3, R)),
        jnp.ones((R,), bool), stream_uniform(key, 0, (R,)),
        stream_uniform(key, 1, (R,)), None, *segment_flags(cfg, 0),
    )
    return npos, ndir


def brute_tiled(m, m_a, valid, pos3, dir3, ray_tile, t_chunk=None):
    """`intersect_brute` over ray tiles (bounds its [rays, tris, 3]
    intermediates)."""
    import jax
    import jax.numpy as jnp

    from montecarlopathtracer.ops.intersect import intersect_brute

    R = pos3.shape[1]
    pad = (-R) % ray_tile
    p = jnp.pad(pos3, ((0, 0), (0, pad)))
    d = jnp.pad(dir3, ((0, 0), (0, pad)), constant_values=1.0)
    n = p.shape[1] // ray_tile
    p = p.reshape(3, n, ray_tile).transpose(1, 0, 2)
    d = d.reshape(3, n, ray_tile).transpose(1, 0, 2)
    hit = jax.lax.map(
        lambda x: intersect_brute(m, m_a, valid, x[0].T, x[1].T,
                                  t_chunk=t_chunk),
        (p, d),
    )
    return jax.tree.map(lambda v: v.reshape((-1,) + v.shape[2:])[:R], hit)


def f64_winners(a, b, c, valid, pos3, dir3, ray_tile):
    """The oracle in float64 from the same vertices: the judge of rays
    on which two f32 pipelines disagree."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from montecarlopathtracer.ops.intersect import triangle_transforms

    T = a.shape[0]
    t_chunk = max(k for k in range(1, T + 1)
                  if T % k == 0 and k * ray_tile * 48 <= 6e9)
    with jax.enable_x64(True):
        f64 = lambda x: jnp.asarray(np.asarray(x), jnp.float64)  # noqa: E731
        m, m_a = triangle_transforms(f64(a), f64(b), f64(c))
        hit = jax.jit(brute_tiled, static_argnums=(5, 6))(
            m, m_a, valid, f64(pos3), f64(dir3), ray_tile, t_chunk)
        return np.asarray(hit.tri_id)


def compare_winners(scene, pos3, dir3, ray_tile, t_chunk=None):
    """Nearest kernel vs the f32 oracle (HIGHEST) on one wavefront.

    Two f32 pipelines round differently, so winners may differ on rays
    that graze a shared edge. The gate (PERF.md, "exactness gate"):
    every differing ray is a near tie in t or an edge graze; the
    differing share is at most MAX_DIFF_SHARE, or twice the f32
    oracle's own disagreement with the float64 oracle where that is
    larger; and the kernel disagrees with float64 at most twice as
    often as the f32 oracle does, plus MAX_DIFF_SHARE."""
    import jax
    import numpy as np

    from montecarlopathtracer.ops.intersect import triangle_transforms
    from montecarlopathtracer.ops.nearest import nearest_index, refine_hit

    a, b, c = scene.triangle_vertices()
    m, m_a = triangle_transforms(a, b, c)
    valid = scene.tri_valid
    kern = jax.jit(nearest_index)
    brute = jax.jit(brute_tiled, static_argnums=(5, 6))
    idx = kern(m, m_a, valid, pos3, dir3).block_until_ready()
    ref = brute(m, m_a, valid, pos3, dir3, ray_tile, t_chunk)
    jax.block_until_ready(ref)
    t_k = _median_time(lambda: kern(m, m_a, valid, pos3, dir3))
    t_b = _median_time(
        lambda: brute(m, m_a, valid, pos3, dir3, ray_tile, t_chunk), n=3
    )
    o, d = pos3.T, dir3.T
    mine = refine_hit(m, m_a, o, d, idx)
    theirs = refine_hit(m, m_a, o, d, ref.tri_id)
    k_id, b_id = np.asarray(idx), np.asarray(ref.tri_id)
    same = k_id == b_id
    for f in ("t", "beta", "gamma"):  # refine is one function of the index
        x, y = np.asarray(getattr(mine, f)), np.asarray(getattr(theirs, f))
        if not np.array_equal(x[same], y[same]):
            raise AssertionError(f"refined {f} differs on agreeing winners")
    truth = f64_winners(a, b, c, valid, pos3, dir3, ray_tile)
    diff = ~same
    out = dict(
        rays=int(k_id.size),
        hit_share=float((b_id >= 0).mean()),
        diff_share=float(diff.mean()),
        kernel_vs_f64=float((k_id != truth).mean()),
        oracle_vs_f64=float((b_id != truth).mean()),
        kernel_ms=1e3 * t_k,
        brute_ms=1e3 * t_b,
    )
    if diff.any():
        out.update(_judge(a, b, c, o, d, k_id, b_id, diff,
                          np.asarray(mine.t), np.asarray(theirs.t)))
    limit = max(MAX_DIFF_SHARE, 2 * out["oracle_vs_f64"])
    if out["diff_share"] > limit:
        raise AssertionError(f"winner differs on too many rays: {out}")
    if out["kernel_vs_f64"] > 2 * out["oracle_vs_f64"] + MAX_DIFF_SHARE:
        raise AssertionError(f"kernel less exact than the oracle: {out}")
    return out


def _judge(a, b, c, o, d, k_id, b_id, diff, t_k, t_b):
    """Classify the differing rays with a float64 evaluation of both
    winners: near tie in t, or edge graze (the ray passes within EDGE
    of an edge of one of the two candidate triangles)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from montecarlopathtracer.ops.intersect import triangle_transforms
    from montecarlopathtracer.ops.nearest import refine_hit

    sel = np.where(diff)[0]
    with jax.enable_x64(True):
        f64 = lambda x: jnp.asarray(np.asarray(x), jnp.float64)  # noqa: E731
        m64, ma64 = triangle_transforms(f64(a), f64(b), f64(c))
        oo, dd = f64(np.asarray(o)[sel]), f64(np.asarray(d)[sel])

        def edge_dist(ids):
            h = refine_hit(m64, ma64, oo, dd, jnp.asarray(ids))
            bb, gg = np.asarray(h.beta), np.asarray(h.gamma)
            e = np.minimum(np.minimum(bb, gg), 1.0 - bb - gg)
            return np.where(np.asarray(ids) >= 0, np.abs(e), np.inf)

        edge = np.minimum(edge_dist(k_id[sel]), edge_dist(b_id[sel]))
    tie = np.abs(t_k[sel] - t_b[sel]) <= NEAR_TIE * np.abs(t_b[sel])
    bad = ~(tie | (edge <= EDGE))
    if bad.any():
        raise AssertionError(
            f"{int(bad.sum())} differing rays are neither near ties nor "
            f"edge grazes: kernel t {t_k[sel][bad][:5]}, oracle t "
            f"{t_b[sel][bad][:5]}, edge distances {edge[bad][:5]}"
        )
    return dict(
        n_diff=int(sel.size),
        near_ties=int(tie.sum()),
        edge_grazes=int((~tie).sum()),
        max_graze_edge_dist=float(np.max(np.where(tie, 0.0, edge))),
    )


def _median_time(fn, n=5):
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def kernel_phase():
    import jax.numpy as jnp

    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.models.bunny import bunny_scene

    scene, cam = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=W, height=H
    )
    pos3, dir3 = primary_rays(cam, W, H)
    phase("kernel", "cornell-full primary "
          + json.dumps(compare_winners(scene, pos3, dir3, 60000)))
    bpos, bdir = bounce_rays(scene, pos3, dir3)
    phase("kernel", "cornell-full bounce "
          + json.dumps(compare_winners(scene, bpos, bdir, 60000)))
    bs, bcam = bunny_scene(width=BUNNY, height=BUNNY)
    T = bs.num_triangles
    R = BUNNY * BUNNY // 16
    # Largest triangle chunk dividing T whose [R, chunk, 3] f32 pair
    # stays under 6 GB.
    t_chunk = max(k for k in range(1, T + 1)
                  if T % k == 0 and k * R * 24 <= 6e9)
    ppos, pdir = primary_rays(bcam, BUNNY, BUNNY, stride=16)
    stats = compare_winners(bs, ppos, pdir, R, t_chunk)
    stats["triangles"] = int(jnp.sum(bs.tri_valid))
    phase("kernel", "bunny 64k primary " + json.dumps(stats))


# -- phase 5: renders through the CLI ---------------------------------------


def cli_render(args):
    """Run ``cli.main(args)`` in this process; return its per-pass log
    records and the render line."""
    from montecarlopathtracer import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args)
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}: {err.getvalue()[-2000:]}")
    lines = err.getvalue().splitlines()
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    setup = next(x for x in lines if x.startswith("render: "))
    return recs, setup


def render_stats(recs, width, height, spp):
    import jax

    first = recs[0]["batch_s"]
    steady = [r["batch_s"] for r in recs[1:]] or [first]
    per_pass = sum(steady) / len(steady)
    return dict(
        compile_s=round(first - per_pass, 3),
        msamples_s=round(width * height * spp / per_pass / 1e6, 3),
        peak_bytes=(jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"),
    )


def film_of(path):
    import numpy as np

    with np.load(path) as z:
        return z["color"], float(z["weight"])


def lockstep_divergence(scene, camera, key, width, height, config, other):
    """One sample of the scan integrator on ``config.intersector``, with
    the ``other`` intersector's winner computed beside it on the same
    rays at every segment. Returns the per-pixel radiance (3, H, W) and
    whether any segment's winners differed along the pixel's path. One
    jitted call per segment keeps only one segment's oracle
    intermediates alive."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from montecarlopathtracer.ops.rng import stream_uniform
    from montecarlopathtracer.render.integrator import (
        _make_intersect_shade, segment_epilogue, segment_flags,
    )

    R = width * height
    shade_n = _make_intersect_shade(scene, config, None)
    shade_b = _make_intersect_shade(
        scene, dataclasses.replace(config, intersector=other), None)

    @jax.jit
    def step(pos, dir_, thr, res, live, div, seg):
        s = shade_n(pos, dir_)
        div = div | (live & (s["tri_id"] != shade_b(pos, dir_)["tri_id"]))
        u1 = stream_uniform(key, seg * 4 + 0, (R,))
        u2 = stream_uniform(key, seg * 4 + 1, (R,))
        urr = (stream_uniform(key, seg * 4 + 3, (R,))
               if config.mode == "rr" else None)
        return segment_epilogue(
            config, s, pos, dir_, thr, res, live, u1, u2, urr,
            *segment_flags(config, seg),
        ) + (div,)

    pix = jnp.arange(R)
    jx = stream_uniform(key, 1 << 30, (R,)) * 2.0 - 1.0
    jy = stream_uniform(key, (1 << 30) + 1, (R,)) * 2.0 - 1.0
    pos, dir_ = camera.generate_rays_soa(pix % width, pix // width, jx, jy,
                                         width, height)
    state = (pos, dir_, jnp.ones((3, R)), jnp.zeros((3, R)),
             jnp.ones((R,), bool), jnp.zeros((R,), bool))
    for seg in range(config.num_segments):
        state = step(*state, jnp.int32(seg))
    res, div = state[3], state[5]
    return res.reshape(3, height, width), div.reshape(height, width)


def render_phase(outdir):
    import dataclasses

    import jax
    import numpy as np

    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.ops.rng import make_key
    from montecarlopathtracer.render.integrator import TraceConfig

    spp, passes = 4, 3
    common = ["--scene", "cornell-full", "--width", str(W), "--height",
              str(H), "--max-depth", "7", "--spp-per-pass", str(spp),
              "--passes", str(passes), "--seed", "3", "--ray-chunk", "0"]
    films = {}
    for name in ("auto", "brute"):
        ck = os.path.join(outdir, f"cornell_{name}.npz")
        if os.path.exists(ck):
            os.remove(ck)  # a stale checkpoint would resume
        recs, setup = cli_render(common + [
            "--intersector", name, "--checkpoint", ck,
            "--out", os.path.join(outdir, f"cornell_{name}.png")])
        if name == "auto" and "intersector=nearest" not in setup:
            raise AssertionError(f"auto did not pick the kernel: {setup}")
        films[name] = film_of(ck)
        phase("render", f"cornell-full {W}x{H} {name}: {setup[8:]} "
              + json.dumps(render_stats(recs, W, H, spp)))
    (fa, wa), (fb, wb) = films["auto"], films["brute"]
    assert wa == wb == spp * passes and np.isfinite(fa).all()
    mae = float(np.abs(fa - fb).mean())
    if mae > 1e-3:
        raise AssertionError(f"nearest vs brute film MAE {mae}")
    # Trace each differing pixel of the first sample to a differing
    # winner: same key as the CLI's pass 0, sample 0.
    scene, cam = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=W, height=H)
    cfg = TraceConfig(max_depth=7, ray_chunk=0, intersector="nearest")
    key = jax.random.fold_in(jax.random.fold_in(make_key(3), 0), 0)
    # Each path is traced by its own intersector with the other one's
    # winner checked beside it; both runs share the step program.
    rad_n, div_n = lockstep_divergence(scene, cam, key, W, H, cfg, "brute")
    rad_b, div_b = lockstep_divergence(
        scene, cam, key, W, H,
        dataclasses.replace(cfg, intersector="brute"), "nearest")
    rad_n, rad_b = np.asarray(rad_n), np.asarray(rad_b)
    diverged = np.asarray(div_n) | np.asarray(div_b)
    differs = (np.abs(rad_n - rad_b) > 1e-4 * (1.0 + np.abs(rad_b))).any(0)
    untraced = int((differs & ~diverged).sum())
    phase("render", json.dumps(dict(
        film_mae=mae, sample0_pixels_differing=int(differs.sum()),
        sample0_pixels_with_differing_winner=int(diverged.sum()),
        untraced=untraced)))
    if untraced:
        raise AssertionError(f"{untraced} pixels differ with equal winners")

    recs, setup = cli_render([
        "--scene", "cornell-full", "--width", str(W), "--height", str(H),
        "--mode", "rr", "--illum", "1", "--spp-per-pass", "8",
        "--passes", "3", "--out", os.path.join(outdir, "cornell_rr.png")])
    if "regen=True" not in setup:
        raise AssertionError(f"rr render did not take regen: {setup}")
    phase("render", f"cornell-full rr regen: {setup[8:]} "
          + json.dumps(render_stats(recs, W, H, 8)))

    recs, setup = cli_render([
        "--scene", "bunny", "--width", str(BUNNY), "--height", str(BUNNY),
        "--spp-per-pass", "1", "--passes", "2",
        "--out", os.path.join(outdir, "bunny.png")])
    phase("render", f"bunny {BUNNY}x{BUNNY}: {setup[8:]} "
          + json.dumps(render_stats(recs, BUNNY, BUNNY, 1)))


# -- phase 6: gradient ------------------------------------------------------


def gradient_phase():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from montecarlopathtracer.diff.grad import (
        make_loss_fn, make_sgd_step, render_image, split_params,
    )
    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.render.integrator import TraceConfig

    scene, cam = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=W, height=H)
    target = jnp.zeros((H, W, 3), jnp.float32)
    params = split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    grads = {}
    for name in ("nearest", "brute"):
        cfg = TraceConfig(max_depth=7, ray_chunk=30000, intersector=name)
        loss_fn = make_loss_fn(scene, cam, target, width=W, height=H,
                               spp=2, config=cfg)
        vg = jax.jit(jax.value_and_grad(loss_fn))
        t0 = time.perf_counter()
        loss, g = vg(params, jax.random.key(7))
        jax.block_until_ready(g)
        t_first = time.perf_counter() - t0
        t_step = _median_time(lambda: vg(params, jax.random.key(7)), n=3)
        grads[name] = jax.tree.map(np.asarray, g)
        for k, v in grads[name].items():
            if not np.isfinite(v).all():
                raise AssertionError(f"{name} gradient of {k} not finite")
        phase("grad", f"{name}: loss {float(loss):.6f} first call "
              f"{t_first:.2f}s, step {t_step:.3f}s "
              f"({W * H * 2 / t_step / 1e6:.3f} Msamples/s fwd+bwd)")
    rel = {}
    for k in params:
        gn, gb = grads["nearest"][k], grads["brute"][k]
        den = np.linalg.norm(gb)
        rel[k] = float(np.linalg.norm(gn - gb) / den) if den else float(
            np.linalg.norm(gn))
    phase("grad", "relative L2 nearest vs brute " + json.dumps(rel))
    if max(rel.values()) > 1e-3:
        raise AssertionError(f"gradients disagree: {rel}")

    cfg = TraceConfig(max_depth=7, ray_chunk=0, intersector="nearest")
    key = jax.random.key(20)
    target = render_image(split_params(scene, ("mat_kd",)), scene, cam, key,
                          width=W, height=H, spp=2, config=cfg)
    loss_fn = make_loss_fn(scene, cam, target, width=W, height=H, spp=2,
                           config=cfg)
    step = make_sgd_step(loss_fn, lr=1.0)
    p = {"mat_kd": scene.mat_kd * 0.6}
    losses = []
    for _ in range(3):
        p, loss = step(p, key)
        losses.append(float(loss))
    phase("grad", f"sgd losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")


# -- --four: the sharded path ------------------------------------------------


def four_phase():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.parallel.mesh import make_mesh
    from montecarlopathtracer.parallel.sharded import (
        make_geom_train_step, make_progressive_step,
    )
    from montecarlopathtracer.render.film import Film
    from montecarlopathtracer.render.integrator import (
        TraceConfig, render_rows,
    )

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(jax.devices())}")
    scene, cam = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=W, height=H)
    cfg = TraceConfig(max_depth=7, ray_chunk=0, intersector="nearest")
    spp = 4
    key = jax.random.key(5)
    band = jax.jit(render_rows, static_argnums=(3, 4, 6, 7))
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(*shape, devices=jax.devices()[:4])
        step = make_progressive_step(mesh, width=W, height=H, spp=spp,
                                     config=cfg)
        t0 = time.perf_counter()
        film = step(scene, cam, Film.zeros(H, W), key)
        film.color.block_until_ready()
        t_first = time.perf_counter() - t0
        t_step = _median_time(
            lambda: step(scene, cam, Film.zeros(H, W), key).color, n=3)
        got = np.asarray(film.color)
        # The same bands, one after another on one card, same folded keys.
        n_rays, n_spp = shape
        rows = H // n_rays
        ref = np.zeros((H, W, 3), np.float32)
        for ri in range(n_rays):
            acc = 0.0
            for si in range(n_spp):
                dev_key = jax.random.fold_in(key, ri * 65536 + si)
                for s in range(spp // n_spp):
                    acc = acc + np.asarray(band(
                        scene, cam, jax.random.fold_in(dev_key, s), W, H,
                        ri * rows, rows, cfg))
            ref[ri * rows:(ri + 1) * rows] = acc / spp
        err = float(np.max(np.abs(got - ref)))
        phase("four", f"progressive step mesh {shape}: first call "
              f"{t_first:.2f}s, step {t_step:.3f}s "
              f"({W * H * spp / t_step / 1e6:.3f} Msamples/s), "
              f"max |film - bands| {err:.3g}, weight {float(film.weight)}")
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    ka = np.asarray(scene.mat_ka)
    emit = np.where((ka > 0).any(axis=1))[0]
    tri_mask = np.isin(np.asarray(scene.tri_mat), emit) & np.asarray(
        scene.tri_valid)
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    cfg2 = TraceConfig(max_depth=2, ray_chunk=0, intersector="nearest")
    target = np.asarray(make_progressive_step(
        mesh, width=W, height=H, spp=spp, config=cfg2,
    )(scene, cam, Film.zeros(H, W), key).color)
    geom = make_geom_train_step(mesh, scene, cam, tri_mask, width=W,
                                height=H, spp=spp, config=cfg2,
                                n_edge_samples=4096)
    theta, loss = geom(jnp.asarray([0.5, 0.0, 0.0]), target,
                       jax.random.key(9))
    theta = np.asarray(theta)
    phase("four", f"geom train step: loss {float(loss):.6g}, theta {theta}")
    if not (np.isfinite(theta).all() and np.isfinite(float(loss))):
        raise AssertionError("geometry step not finite")


def main(argv) -> int:
    four = "--four" in argv
    phase("card", card_line())
    import montecarlopathtracer  # noqa: F401  (fails outside the repo)

    if not four:
        phase("tests", run_gpu_tests())

    import jax

    from montecarlopathtracer.utils.compile_cache import enable_compile_cache

    phase("cache", enable_compile_cache())
    dev = jax.devices()[0]
    phase("device", f"platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}")
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    if four:
        four_phase()
    else:
        kernel_phase()
        outdir = os.path.join(ROOT, "chiprun_out", "smoke")
        os.makedirs(outdir, exist_ok=True)
        render_phase(outdir)
        gradient_phase()
    phase("card", card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
