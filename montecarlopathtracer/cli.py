"""Command-line renderer — the framework's equivalent of the
reference's batch entry point (`CVMCTracer/CVMCTracer/main.cpp`) with
the compile-time constants promoted to flags (SURVEY.md §5 config gap).

Examples:
    # render the reference scene 1 like the CUDA backend (100 passes ×
    # 100 spp at 800×600, fixed depth 7, linear output):
    python -m montecarlopathtracer.cli --scene 1 --out result1.png

    # procedural Cornell with spheres, RR termination, gamma output:
    python -m montecarlopathtracer.cli --scene cornell-full \
        --mode rr --tonemap gamma --width 640 --height 480
"""

from __future__ import annotations

import argparse
import sys

from .models import cornell
from .render.integrator import TraceConfig, resolve_intersector
from .render.renderer import Renderer, RenderSettings
from .utils.logging import RenderLog


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="montecarlopathtracer",
        description="Differentiable Monte Carlo path tracer in JAX",
    )
    p.add_argument(
        "--scene",
        default="1",
        help="1/2/3 = reference scene (read-only mount), 'mcrt' = the "
        "MCRT backend's scene01 variant (per-triangle materials, π/4 "
        "camera), 'cornell' = procedural box, 'cornell-full' = "
        "procedural box with mirror + glass spheres, 'bunny' = large "
        "procedural benchmark scene, or a path to an .obj file",
    )
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp-per-pass", type=int, default=4)
    p.add_argument("--passes", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", choices=["fixed", "rr"], default="fixed")
    p.add_argument("--max-depth", type=int, default=7)
    p.add_argument("--rr-depth", type=int, default=5)
    p.add_argument("--illum", type=float, default=10.0)
    p.add_argument(
        "--ray-chunk",
        type=int,
        default=None,
        help="rays per wavefront tile (default: whole frame for the "
        "nearest kernel, 30000 for the lax paths, which materialize a "
        "[rays, tris] intermediate)",
    )
    p.add_argument(
        "--eye",
        type=float,
        nargs=3,
        default=None,
        metavar=("X", "Y", "Z"),
        help="camera position (overrides the scene's hardcoded camera)",
    )
    p.add_argument(
        "--lookat",
        type=float,
        nargs=3,
        default=None,
        metavar=("X", "Y", "Z"),
        help="camera look-at point (requires --eye)",
    )
    p.add_argument(
        "--up",
        type=float,
        nargs=3,
        default=(0.0, 1.0, 0.0),
        metavar=("X", "Y", "Z"),
        help="camera up vector (with --eye/--lookat)",
    )
    p.add_argument(
        "--fov",
        type=float,
        default=60.0,
        help="horizontal FOV in degrees (with --eye)",
    )
    p.add_argument(
        "--intersector",
        choices=["auto", "nearest", "brute", "kdtree"],
        default="auto",
        help="'auto' = the Triton 'nearest' kernel on a CUDA GPU, the "
        "lax 'brute' oracle on the CPU. 'kdtree' builds the accelerator "
        "(native C++ builder when available) and walks it with the lax "
        "stackless traversal",
    )
    p.add_argument(
        "--phong-model",
        choices=["blinn", "phong"],
        default="blinn",
        help="specular sampler: 'blinn' = half-vector (the committed "
        "reference code); 'phong' = classic reflection lobe (MC.docx "
        "Figure 4 variant)",
    )
    p.add_argument(
        "--regen",
        choices=["auto", "on", "off"],
        default="auto",
        help="regenerating wavefront (render/regen.py): lanes restart "
        "the next sample the step their path dies, keeping ~100%% "
        "occupancy through RR tails. 'auto' = on in rr mode; unbiased "
        "but not pass-exact vs the scan integrator for spp > 1",
    )
    p.add_argument("--tonemap", choices=["linear", "gamma"], default="linear")
    p.add_argument(
        "--accum",
        choices=["linear", "gamma"],
        default="linear",
        help="film accumulation space: 'linear' (CUDA estimator) or "
        "'gamma' (MCRT's gamma-space running mean, rtx.hlsl:400-404)",
    )
    p.add_argument("--out", default="result.png")
    p.add_argument("--step-dir", default=None, help="per-pass PNG dump dir")
    p.add_argument(
        "--preview",
        action="store_true",
        help="with --step-dir: keep an atomically-updated preview.png "
        "+ a self-refreshing index.html for a live progressive view "
        "(the reference's cvShowImage/swapchain capability)",
    )
    p.add_argument("--checkpoint", default=None, help="film checkpoint path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument(
        "--profile-dir",
        default=None,
        help="write a jax.profiler trace of the render here",
    )
    p.add_argument("--quiet", action="store_true")
    return p


def load_scene(name: str, width: int, height: int):
    if name in ("1", "2", "3"):
        return cornell.load_reference_scene(int(name), width=width, height=height)
    if name == "mcrt":
        return cornell.load_mcrt_scene(width=width, height=height)
    if name == "cornell":
        return cornell.cornell_box(width=width, height=height)
    if name == "cornell-full":
        return cornell.cornell_box(
            with_mirror_sphere=True,
            with_glass_sphere=True,
            width=width,
            height=height,
        )
    if name == "bunny":
        from .models.bunny import bunny_scene

        return bunny_scene(width=width, height=height)
    from .scene.scene import load_obj_scene
    from .scene.camera import camera_for_scene

    return load_obj_scene(name), camera_for_scene(1, width, height)


def resolve_ray_chunk(requested, intersector: str) -> int:
    """An explicit ``--ray-chunk`` always wins. Default: whole-frame
    wavefront for the nearest kernel (it never materializes [rays,
    tris]), 30000-ray tiles for the lax paths (which do)."""
    if requested is not None:
        return requested
    return 0 if intersector == "nearest" else 30000


def main(argv=None) -> int:
    import jax

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    scene, camera = load_scene(args.scene, args.width, args.height)
    if args.eye is not None:
        from .scene.camera import Camera
        import numpy as np

        lookat = (
            args.lookat
            if args.lookat is not None
            else tuple(np.asarray(args.eye) + np.asarray((0.0, 0.0, -1.0)))
        )
        camera = Camera.look(
            args.eye,
            tuple(np.asarray(lookat) - np.asarray(args.eye)),
            args.up,
            width=args.width,
            height=args.height,
            fov_x_deg=args.fov,
            jitter=camera.jitter,
        )
    elif args.lookat is not None:
        raise SystemExit("--lookat requires --eye")

    intersector = resolve_intersector(args.intersector, jax.default_backend())
    ray_chunk = resolve_ray_chunk(args.ray_chunk, intersector)

    accel = None
    if intersector == "kdtree":
        import numpy as np

        from .accel.kdtree import build_flat_kdtree
        from .ops.traverse import KDArrays

        a, b, c = scene.triangle_vertices()
        flat = build_flat_kdtree(
            np.asarray(a), np.asarray(b), np.asarray(c),
            np.asarray(scene.tri_valid),
        )
        accel = KDArrays.from_flat(flat)

    config = TraceConfig(
        mode=args.mode,
        max_depth=args.max_depth,
        rr_depth=args.rr_depth,
        illum=args.illum,
        ray_chunk=ray_chunk,
        intersector=intersector,
        phong_model=args.phong_model,
    )
    # Regen auto policy: RR paths die at scattered depths, and refilling
    # dead lanes beats paying every segment at full width. Fixed-depth
    # paths mostly run to the end, so the scan integrator keeps them.
    # Regen traces the whole frame as one wavefront, so a tiled
    # wavefront (--ray-chunk, or a lax intersector's default) keeps
    # the scan integrator.
    regen = args.regen == "on" or (
        args.regen == "auto" and args.mode == "rr" and ray_chunk == 0
    )
    settings = RenderSettings(
        width=args.width,
        height=args.height,
        spp_per_pass=args.spp_per_pass,
        passes=args.passes,
        seed=args.seed,
        tonemap=args.tonemap,
        accum=args.accum,
        step_dir=args.step_dir,
        preview=args.preview,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        regen=regen,
    )
    log = RenderLog(enabled=not args.quiet)
    if not args.quiet:
        print(
            f"render: platform={jax.default_backend()} "
            f"intersector={intersector} regen={regen} "
            f"triangles={int(scene.num_triangles)}",
            file=sys.stderr,
        )
    r = Renderer(scene, camera, config, settings, log=log, accel=accel)
    from .utils.profiling import trace

    with trace(args.profile_dir):
        r.render()
    r.save_png(args.out)
    if not args.quiet:
        print(
            f"wrote {args.out} ({args.width}x{args.height}, "
            f"{float(r.film.weight):.0f} spp)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
