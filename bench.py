"""Headline benchmark: Cornell-box path-tracing throughput on a CUDA GPU.

Matches the reference's benchmark workload (MC.docx results table,
BASELINE.md): scene-1 Cornell box at 800×600, fixed depth 7 + final
emission gather. The reference achieves ≈2.4 Msamples/s on a GTX 1070
(1000 spp in 200 s).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Msamples/s", "vs_baseline": N,
   "device": {"platform", "kind", "count", "power_limit"}, ...}
Diagnostics go to stderr. Exits non-zero when JAX finds no GPU.

Environment knobs: BENCH_WIDTH, BENCH_HEIGHT, BENCH_SPP_PER_PASS,
BENCH_PASSES, BENCH_INTERSECTOR (default "auto"), BENCH_RAY_CHUNK,
BENCH_GRAD=0 / BENCH_RR=0 to skip those blocks, BENCH_PROFILE_DIR.
"""

import json
import os
import subprocess
import sys
import time

import jax

BASELINE_MSAMPLES_S = 2.4  # GTX 1070, MC.docx results table


def _power_limit() -> str:
    """The card's power limit, read by ``nvidia-smi`` (a child process
    that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def main():
    from montecarlopathtracer.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "power_limit": _power_limit(),
    }

    from montecarlopathtracer.cli import resolve_ray_chunk
    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.render.integrator import (
        TraceConfig,
        resolve_intersector,
    )
    from montecarlopathtracer.render.renderer import (
        Renderer,
        RenderSettings,
    )
    from montecarlopathtracer.utils.logging import RenderLog

    width = int(os.environ.get("BENCH_WIDTH", 800))
    height = int(os.environ.get("BENCH_HEIGHT", 600))
    spp_per_pass = int(os.environ.get("BENCH_SPP_PER_PASS", 4))
    passes = int(os.environ.get("BENCH_PASSES", 4))

    if cornell.has_reference_scenes():
        scene, camera = cornell.load_reference_scene(1, width=width, height=height)
        scene_name = "scene01(ref)"
    else:
        scene, camera = cornell.cornell_box(
            with_mirror_sphere=True,
            with_glass_sphere=True,
            width=width,
            height=height,
        )
        scene_name = "cornell(procedural)"
    intersector = resolve_intersector(
        os.environ.get("BENCH_INTERSECTOR", "auto"), dev.platform
    )
    env_chunk = os.environ.get("BENCH_RAY_CHUNK")
    ray_chunk = resolve_ray_chunk(
        int(env_chunk) if env_chunk else None, intersector
    )

    config = TraceConfig(
        mode="fixed",
        max_depth=7,
        illum=10.0,
        ray_chunk=ray_chunk,
        intersector=intersector,
    )
    settings = RenderSettings(
        width=width, height=height, spp_per_pass=spp_per_pass, seed=0
    )
    log = RenderLog(stream=sys.stderr)
    r = Renderer(scene, camera, config, settings, log=log)

    print(
        f"bench: {scene_name} T={scene.num_triangles} {width}x{height} "
        f"depth=7+1 spp/pass={spp_per_pass} passes={passes} "
        f"intersector={intersector} device={json.dumps(device)}",
        file=sys.stderr,
    )

    # Warm-up (compile).
    t0 = time.perf_counter()
    r.render(1)
    r.film.color.block_until_ready()
    warmup_s = time.perf_counter() - t0
    print(f"warmup pass: {warmup_s:.1f}s", file=sys.stderr)

    from montecarlopathtracer.utils.profiling import trace

    # Time rendering, not logging: the per-pass log fences every pass.
    log.enabled = False
    t0 = time.perf_counter()
    with trace(os.environ.get("BENCH_PROFILE_DIR")):
        r.render(passes)
        r.film.color.block_until_ready()
    dt = time.perf_counter() - t0
    log.enabled = True

    samples = width * height * spp_per_pass * passes
    msamples_s = samples / dt / 1e6
    print(
        f"{dt:.2f}s for {samples} samples → {msamples_s:.2f} Msamples/s "
        f"({msamples_s * 8:.1f} Mray-segments/s)",
        file=sys.stderr,
    )

    # ---- fwd+bwd (the BASELINE north-star metric: grad throughput) ----
    # jax.grad of the pixel L2 loss; path replay via jax.checkpoint.
    # Params = {Kd, Ka, vertices} (the BASELINE inverse-rendering
    # configs 4-5).
    fwdbwd_msamples_s = None
    if os.environ.get("BENCH_GRAD", "1") != "0":
        import jax.numpy as jnp

        from montecarlopathtracer.diff.grad import (
            make_loss_fn,
            split_params,
        )

        gspp = int(os.environ.get("BENCH_GRAD_SPP", 2))
        gcfg = TraceConfig(
            mode="fixed", max_depth=7, illum=10.0, ray_chunk=ray_chunk,
            intersector=intersector,
        )
        target = jnp.zeros((height, width, 3), jnp.float32)
        loss_fn = make_loss_fn(
            scene, camera, target,
            width=width, height=height, spp=gspp, config=gcfg,
        )
        params = split_params(scene, ("mat_kd", "mat_ka", "vertices"))
        vg = jax.jit(jax.value_and_grad(loss_fn))
        t0 = time.perf_counter()
        loss, grads = vg(params, jax.random.key(7))
        jax.block_until_ready(grads)
        print(
            f"grad compile+first step: {time.perf_counter() - t0:.1f}s "
            f"(loss {float(loss):.4f})",
            file=sys.stderr,
        )
        iters = int(os.environ.get("BENCH_GRAD_ITERS", 3))
        t0 = time.perf_counter()
        for i in range(iters):
            loss, grads = vg(params, jax.random.key(8 + i))
        jax.block_until_ready(grads)
        gdt = time.perf_counter() - t0
        gsamples = width * height * gspp * iters
        fwdbwd_msamples_s = gsamples / gdt / 1e6
        print(
            f"fwd+bwd: {gdt:.2f}s for {gsamples} samples → "
            f"{fwdbwd_msamples_s:.2f} Msamples/s",
            file=sys.stderr,
        )

    # ---- RR mode via the regenerating wavefront (render/regen.py) ----
    # The CLI auto default for mode=rr: dead lanes restart the next
    # sample in place. One fenced 32-spp pass, on any intersector.
    rr_regen_msamples_s = None
    if os.environ.get("BENCH_RR", "1") != "0":
        rr_cfg = TraceConfig(
            mode="rr", max_depth=7, illum=1.0, rr_depth=5,
            ray_chunk=0, intersector=intersector,
        )
        rr_settings = RenderSettings(
            width=width, height=height, spp_per_pass=32, seed=0,
            regen=True,
        )
        rr = Renderer(scene, camera, rr_cfg, rr_settings)
        rr.render(1)
        rr.film.color.block_until_ready()
        t0 = time.perf_counter()
        rr.render(2)
        rr.film.color.block_until_ready()
        rr_dt = time.perf_counter() - t0
        rr_regen_msamples_s = width * height * 32 * 2 / rr_dt / 1e6
        print(
            f"rr regen (32 spp/pass): {rr_regen_msamples_s:.2f} "
            f"Msamples/s",
            file=sys.stderr,
        )

    record = {
        "metric": "cornell_800x600_depth7_samples_throughput",
        "value": round(msamples_s, 3),
        "unit": "Msamples/s",
        "vs_baseline": round(msamples_s / BASELINE_MSAMPLES_S, 3),
        "fwd_msamples_s": round(msamples_s, 3),
        "warmup_s": round(warmup_s, 1),
        "intersector": intersector,
        "device": device,
    }
    if rr_regen_msamples_s is not None:
        record["rr_regen_msamples_s"] = round(rr_regen_msamples_s, 3)
    if fwdbwd_msamples_s is not None:
        record["fwdbwd_msamples_s"] = round(fwdbwd_msamples_s, 3)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
