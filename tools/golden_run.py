"""Golden-image parity runner.

Renders the reference's committed workloads on a CUDA GPU and
compares against its committed PNGs (the reference's only regression
baseline — SURVEY.md §4):

  scene1  — Resources/scene01 @ 800×600, fixed depth 7, 1000 spp,
            linear accumulation/output  vs  result1.png (== the last
            committed step, result1step/step000009.png → 1000 spp)
  scene2  — Resources/scene02 @ 800×600, same config
            vs  result2.png
  mcrt    — MCRT Res/scene01 variant @ 640×480, RR(5) termination,
            no illum scale, gamma-space accumulation, π/4 camera
            vs  MCRT/QuinEngine/result.png

Emitter-scale note: stdafx.h hardcodes ILLUM=10 but MC.docx says the
scene-1 *figures* used emitter luminance 30. Every light path's radiance
is throughput × Ka × illum — the whole (pre-clip) image is LINEAR in
illum — so we render the float film once at illum=10 and fit the scale
s* minimizing full-image MAE against the golden; s*·10 is the effective
illum the golden was rendered with. Both the fitted and the nominal
comparison are recorded.

Writes goldens/*.png + goldens/GOLDEN.json and prints a summary.
Needs the reference checkout (REF below) and a GPU; exits otherwise.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = "/root/reference"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "goldens")


def _fit_scale(ours_lin: np.ndarray, golden_u8: np.ndarray) -> float:
    """Scale s minimizing MAE(clip(s·ours·255), golden) via golden-section
    search on a smooth bracket (the objective is piecewise smooth)."""
    g = golden_u8.astype(np.float64) / 255.0
    o = ours_lin.astype(np.float64)

    def mae(s):
        return np.abs(np.clip(o * s, 0, 1.0) - g).mean()

    lo, hi = 0.25, 8.0
    for _ in range(60):
        m1 = lo + (hi - lo) * 0.382
        m2 = lo + (hi - lo) * 0.618
        if mae(m1) < mae(m2):
            hi = m2
        else:
            lo = m1
    return float((lo + hi) / 2)


def render_film(scene, cam, config, settings):
    from montecarlopathtracer.render.renderer import Renderer
    from montecarlopathtracer.utils.logging import RenderLog

    r = Renderer(scene, cam, config, settings, log=RenderLog(stream=sys.stderr))
    t0 = time.perf_counter()
    r.render()
    dt = time.perf_counter() - t0
    spp = settings.spp_per_pass * settings.passes
    print(
        f"  rendered {settings.width}x{settings.height} @ {spp} spp "
        f"in {dt:.1f}s ({settings.width*settings.height*spp/dt/1e6:.2f} Ms/s)",
        file=sys.stderr,
    )
    return r


def main() -> int:
    import argparse

    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="substring filter: run "
                    "only matching sections (scene1/scene2/mcrt/scene3) "
                    "and merge into the existing GOLDEN.json")
    args = ap.parse_args()

    def want(name):
        return not args.only or args.only in name

    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.render.integrator import TraceConfig
    from montecarlopathtracer.utils.compile_cache import enable_compile_cache
    from montecarlopathtracer.render.renderer import RenderSettings
    from montecarlopathtracer.render.film import tonemap_linear, tonemap_identity
    from montecarlopathtracer.utils.golden import compare_images
    from montecarlopathtracer.utils.image import load_png, save_png

    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"golden_run renders on a GPU, found {backend!r}")
    dev = jax.devices()[0]
    print(f"device: {dev.device_kind} x{len(jax.devices())}", file=sys.stderr)
    intersector = "nearest"
    spp_scale = 1
    report = {"platform": dev.platform, "device_kind": dev.device_kind}

    # ---- scene1 / scene2 vs result1/result2 --------------------------------
    for n, golden_name in ((1, "result1.png"), (2, "result2.png")):
        if not want(f"scene{n}"):
            continue
        golden_path = f"{REF}/CVMCTracer/CVMCTracer/{golden_name}"
        golden = load_png(golden_path)
        scene, cam = cornell.load_reference_scene(n, width=800, height=600)
        config = TraceConfig(
            mode="fixed", max_depth=7, illum=10.0, ray_chunk=0,
            intersector=intersector,
        )
        settings = RenderSettings(
            width=800, height=600,
            spp_per_pass=max(1000 // (100 * spp_scale), 1), passes=100,
            seed=0,
        )
        print(f"scene{n}: rendering vs {golden_name}", file=sys.stderr)
        r = render_film(scene, cam, config, settings)
        film = np.asarray(r.film.color)
        ours_u8 = tonemap_linear(film)
        save_png(os.path.join(OUT, f"scene0{n}_ours.png"), ours_u8)

        nominal = compare_images(ours_u8, golden)
        s = _fit_scale(film, golden)
        fitted_u8 = np.clip(film * s * 255.0, 0, 255).astype(np.uint8)
        save_png(os.path.join(OUT, f"scene0{n}_ours_fitted.png"), fitted_u8)
        fitted = compare_images(fitted_u8, golden)
        report[f"scene{n}"] = {
            "golden": golden_path,
            "spp": int(settings.spp_per_pass * settings.passes),
            "nominal_illum10": nominal,
            "fitted_scale": round(s, 4),
            "effective_illum": round(10.0 * s, 2),
            "fitted": fitted,
        }
        print(f"scene{n}: {json.dumps(report[f'scene{n}'], indent=1)}",
              file=sys.stderr)

    # ---- progressive step sequences vs result1step/result2step -------------
    if want("steps"):
        _run_steps(report, spp_scale, intersector)

    # ---- MCRT variant vs MCRT result.png ------------------------------------
    if want("mcrt"):
        _run_mcrt(report, spp_scale, intersector)

    # ---- scene3 vs result3/result4 (Blinn-Phong vs Phong figures) ----------
    if want("scene3") or want("scene3_blinn") or want("scene3_phong"):
        _run_scene3(report, spp_scale, intersector, args.only)

    out_path = os.path.join(OUT, "GOLDEN.json")
    if args.only and os.path.exists(out_path):
        with open(out_path) as f:
            merged = json.load(f)
        merged.update(report)
        report = merged
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


def _run_steps(report, spp_scale, intersector):
    """Progressive-sequence parity (VERDICT r4 missing #3): the
    reference commits result1step/ and result2step/ — 10 frames of the
    progressive running mean, one per 100-spp kernel launch
    (CUTracer.cu:378-397: step k = mean after (k+1)·100 spp; step 9 ==
    result{1,2}.png). Re-render with the same pass semantics
    (spp_per_pass=100, linear running mean — `film_update` implements
    the exact CUTracer.cu:214-217 recurrence) and compare frame by
    frame: per-step 8×-downsampled MAE + PSNR at the final-step fitted
    illum scale. Parity = a monotone-converging curve (both sequences
    estimate the same limit image; MC noise shrinks with spp on both
    sides, ours with different RNG)."""
    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.render.integrator import TraceConfig
    from montecarlopathtracer.utils.compile_cache import enable_compile_cache
    from montecarlopathtracer.render.renderer import (
        Renderer,
        RenderSettings,
    )
    from montecarlopathtracer.render.film import tonemap_linear
    from montecarlopathtracer.utils.golden import compare_images
    from montecarlopathtracer.utils.image import load_png, save_png

    for n in (1, 2):
        step_dir = f"{REF}/CVMCTracer/CVMCTracer/result{n}step"
        goldens = [
            load_png(os.path.join(step_dir, f"step{k:06d}.png"))
            for k in range(10)
        ]
        scene, cam = cornell.load_reference_scene(n, width=800, height=600)
        config = TraceConfig(
            mode="fixed", max_depth=7, illum=10.0, ray_chunk=0,
            intersector=intersector,
        )
        spp_pass = max(100 // spp_scale, 1)
        settings = RenderSettings(
            width=800, height=600, spp_per_pass=spp_pass, passes=10,
            seed=0,
        )
        print(f"steps{n}: 10×{spp_pass} spp vs {step_dir}", file=sys.stderr)
        r = Renderer(scene, cam, config, settings)
        films = []
        for k in range(10):
            r.render(1)
            films.append(np.asarray(r.film.color))
        # One global illum scale, fitted on the CONVERGED final step
        # and applied to every step (the per-step estimator is unbiased,
        # so earlier steps share the same scale).
        s = _fit_scale(films[-1], goldens[-1])
        curve = []
        for k, (film, golden) in enumerate(zip(films, goldens)):
            fitted_u8 = np.clip(film * s * 255.0, 0, 255).astype(np.uint8)
            m = compare_images(fitted_u8, golden)
            curve.append(m)
            if k in (0, 9):
                save_png(
                    os.path.join(OUT, f"scene0{n}_step{k}_ours.png"),
                    fitted_u8,
                )
        maes = [c["mae_down8"] for c in curve]
        psnrs = [c["psnr_db"] for c in curve]
        # The reference's own cross-run floor: result{n}.png vs the
        # sequence's final step. result1step/step9 is BIT-IDENTICAL to
        # result1.png (same run), but result2step is a DIFFERENT run
        # than result2.png (CVMCTracer seeds from std::random_device,
        # CUTracer.cu:375) and sits 0.049 down8-MAE away from it —
        # that scene's fireflies (4 sphere emitters) survive 8×
        # downsampling. A sequence "matches" when it converges to this
        # floor, not to zero.
        final = load_png(
            f"{REF}/CVMCTracer/CVMCTracer/result{n}.png"
        )
        floor = compare_images(final, goldens[-1])["mae_down8"]
        report[f"steps{n}"] = {
            "golden_dir": step_dir,
            "spp_per_step": spp_pass,
            "fitted_scale": round(s, 4),
            "down8_mae_per_step": [round(m, 4) for m in maes],
            "psnr_per_step": [round(p, 2) for p in psnrs],
            "inter_golden_floor_mae_down8": round(floor, 4),
            "converging": bool(
                psnrs[-1] >= psnrs[0]
                and maes[-1] <= max(maes[0], floor * 1.05)
            ),
        }
        print(f"steps{n}: {json.dumps(report[f'steps{n}'], indent=1)}",
              file=sys.stderr)


def _run_mcrt(report, spp_scale, intersector):
    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.render.integrator import TraceConfig
    from montecarlopathtracer.utils.compile_cache import enable_compile_cache
    from montecarlopathtracer.render.renderer import RenderSettings
    from montecarlopathtracer.render.film import tonemap_identity
    from montecarlopathtracer.utils.golden import compare_images
    from montecarlopathtracer.utils.image import load_png, save_png

    golden_path = f"{REF}/MCRT/QuinEngine/result.png"
    golden = load_png(golden_path)
    scene, cam = cornell.load_mcrt_scene(width=640, height=480)
    config = TraceConfig(
        mode="rr", rr_depth=5, illum=1.0, refract_kd=False, ray_chunk=0,
        intersector=intersector,
    )
    # Faithful MCRT estimator: gamma-space running mean of 1-spp frames
    # (rtx.hlsl:400-404) — spp_per_pass must be 1.
    settings = RenderSettings(
        width=640, height=480, spp_per_pass=1,
        passes=max(1024 // spp_scale, 4), seed=0,
        accum="gamma", tonemap="gamma",
    )
    print("mcrt: rendering vs result.png", file=sys.stderr)
    r = render_film(scene, cam, config, settings)
    ours_u8 = tonemap_identity(r.film.color)  # film already gamma-encoded
    save_png(os.path.join(OUT, "mcrt_ours.png"), ours_u8)
    nominal = compare_images(ours_u8, golden)
    # gamma-encoded film: radiance scale s appears as s^(1/2.2)
    film_enc = np.asarray(r.film.color)
    s = _fit_scale(film_enc, golden)
    fitted_u8 = np.clip(film_enc * s * 255.0, 0, 255).astype(np.uint8)
    save_png(os.path.join(OUT, "mcrt_ours_fitted.png"), fitted_u8)
    report["mcrt"] = {
        "golden": golden_path,
        "spp": int(settings.passes),
        "nominal": nominal,
        "fitted_display_scale": round(s, 4),
        "fitted": compare_images(fitted_u8, golden),
    }
    print(f"mcrt: {json.dumps(report['mcrt'], indent=1)}", file=sys.stderr)


def _run_scene3(report, spp_scale, intersector, only=""):
    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.render.integrator import TraceConfig
    from montecarlopathtracer.utils.compile_cache import enable_compile_cache
    from montecarlopathtracer.render.renderer import RenderSettings
    from montecarlopathtracer.render.film import tonemap_linear
    from montecarlopathtracer.utils.golden import compare_images
    from montecarlopathtracer.utils.image import load_png, save_png

    # scene03 is not wired into the reference's main.cpp; result3/4 are
    # MC.docx Figures 3/4 ("Blinn-Phong model" vs "Phong model") of the
    # red/green box whose back wall and floor are Ns=1000 mirrors. The
    # visible "lamp"/"boxes"/"corridor" in the goldens are mirror images
    # — projecting the virtual (reflected) lamp/boxes pins the camera to
    # the scene-1 style eye=(0, 5, ~4.8), −z, 60° FOV our
    # `camera_for_scene(3)` uses. Mirror-heavy transport: needs high spp.
    for variant, phong_model in (("blinn", "blinn"), ("phong", "phong")):
        # A full-spp variant takes ~6 min on chip; let the driver time-
        # slice them (--only scene3_blinn / scene3_phong).
        if only and only.startswith("scene3_") and only != f"scene3_{variant}":
            continue
        scene, cam = cornell.load_reference_scene(3, width=800, height=600)
        config = TraceConfig(
            mode="fixed", max_depth=7, illum=10.0, ray_chunk=0,
            intersector=intersector, phong_model=phong_model,
        )
        settings = RenderSettings(
            width=800, height=600,
            spp_per_pass=max(2048 // (128 * spp_scale), 1), passes=128,
            seed=0,
        )
        print(f"scene3[{variant}]: rendering", file=sys.stderr)
        r = render_film(scene, cam, config, settings)
        film = np.asarray(r.film.color)
        ours_u8 = tonemap_linear(film)
        save_png(os.path.join(OUT, f"scene03_{variant}_ours.png"), ours_u8)
        entry = {
            "spp": int(settings.spp_per_pass * settings.passes),
            "phong_model": phong_model,
        }
        for gn in ("result3.png", "result4.png"):
            golden_path = f"{REF}/CVMCTracer/CVMCTracer/{gn}"
            golden = load_png(golden_path)
            s = _fit_scale(film, golden)
            fitted_u8 = np.clip(film * s * 255.0, 0, 255).astype(np.uint8)
            entry[gn] = {
                "nominal": compare_images(ours_u8, golden),
                "fitted_scale": round(s, 4),
                "fitted": compare_images(fitted_u8, golden),
            }
        report[f"scene3_{variant}"] = entry
        print(f"scene3[{variant}]: {json.dumps(entry, indent=1)}",
              file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
