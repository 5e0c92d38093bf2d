"""Scaling-efficiency harness (BASELINE north star "≥90% linear
scaling").

Measures the sharded SPMD render pass (`parallel/sharded.py`) across
mesh sizes on the GPUs of one host and prints one JSON line per size:
weak scaling, per-device work held constant, efficiency =
t(1 device) / t(n devices). Exits when JAX finds no GPU.

Weak scaling setup: each device owns a fixed 64-row × 512-wide film
band at 2 spp; the mesh grows along the ``rays`` axis, so the frame
height is 64·n. The film psum over the spp axis and the band-sharded
output exercise the collective path at every size.

Usage:
    python tools/scaling_bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS_PER_DEVICE = 64
WIDTH = 512
SPP = 2


def main() -> int:
    import jax

    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.parallel.mesh import make_mesh
    from montecarlopathtracer.parallel.sharded import sharded_sample_pass
    from montecarlopathtracer.render.integrator import (
        TraceConfig,
        render_rows,
    )

    from montecarlopathtracer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"scaling_bench needs a GPU, found {jax.default_backend()!r}")
    n_dev = len(jax.devices())
    kind = jax.devices()[0].device_kind
    print(f"device={kind} devices={n_dev}", file=sys.stderr)

    config = TraceConfig(
        mode="fixed", max_depth=5, ray_chunk=0, intersector="nearest"
    )

    def timed(fn, *args, reps=3):
        fn(*args).block_until_ready()  # compile + warm-up
        t0 = time.perf_counter()
        for r in range(reps):
            out = fn(*args)
        out.block_until_ready()
        return (time.perf_counter() - t0) / reps

    # SPMD bookkeeping overhead, measured directly: the SAME single-
    # device workload with and without the shard_map program around it.
    scene1, cam1 = cornell.cornell_box(width=WIDTH, height=ROWS_PER_DEVICE)
    plain = jax.jit(
        lambda s, c, k: sum(
            render_rows(
                s, c, jax.random.fold_in(k, i), WIDTH, ROWS_PER_DEVICE,
                0, ROWS_PER_DEVICE, config,
            )
            for i in range(SPP)
        )
        / SPP
    )
    t_plain = timed(plain, scene1, cam1, jax.random.key(0))
    mesh1 = make_mesh(1, 1, devices=jax.devices()[:1])
    f1 = sharded_sample_pass(
        mesh1, width=WIDTH, height=ROWS_PER_DEVICE, spp=SPP, config=config
    )
    t_sharded1 = timed(f1, scene1, cam1, jax.random.key(0))
    overhead = {
        "unsharded_seconds": round(t_plain, 4),
        "sharded_1dev_seconds": round(t_sharded1, 4),
        "spmd_overhead_pct": round(100 * (t_sharded1 / t_plain - 1), 1),
    }
    print(json.dumps({"overhead": overhead}), flush=True)

    sizes = [n for n in (1, 2, 4, 8) if n <= n_dev]
    rows = []
    t1 = None
    for n in sizes:
        height = ROWS_PER_DEVICE * n
        scene, cam = cornell.cornell_box(width=WIDTH, height=height)
        mesh = make_mesh(n, 1, devices=jax.devices()[:n])
        f = sharded_sample_pass(
            mesh, width=WIDTH, height=height, spp=SPP, config=config
        )
        dt = timed(f, scene, cam, jax.random.key(0))
        samples = WIDTH * height * SPP
        if t1 is None:
            t1 = dt
        eff = t1 / dt  # weak scaling: same per-device work each size
        row = {
            "devices": n,
            "height": height,
            "seconds_per_pass": round(dt, 4),
            "total_msamples_s": round(samples / dt / 1e6, 3),
            "weak_scaling_efficiency": round(eff, 3),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    print(json.dumps({"device_kind": kind, "results": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
