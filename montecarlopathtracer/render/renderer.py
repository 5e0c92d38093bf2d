"""Progressive renderer: the host-side driver loop.

Plays the role of the reference's `RenderScene` pass loop
(CUTracer.cu:340-404): repeatedly run a jitted sample-batch step,
fold it into the progressive film, optionally dump per-pass PNGs
(`temp/step%06d.png`, CUTracer.cu:394), and checkpoint the exact
restartable state (film + weight + seed + pass index) — which the
reference only *almost* has (its running mean is resumable on-device
but lost on exit; SURVEY.md §3.4/§5).

Details:
- the per-pass step is one jit containing the full wavefront scan for
  ``spp_per_pass`` samples (scan over samples of a full-frame wavefront)
  — no host sync inside a pass;
- film updates run on device; only PNG dumps pull the film to host.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.scene import ScenePack
from ..scene.camera import Camera
from ..ops.rng import make_key
from ..utils.image import save_png
from ..utils.logging import RenderLog
from .film import (
    Film,
    film_update,
    film_update_gamma,
    tonemap_linear,
    tonemap_gamma,
    tonemap_identity,
)
from .integrator import TraceConfig, render_rows_planar


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Run-level configuration (the reference's compile-time constants,
    stdafx.h:41-44, promoted to a config object per SURVEY.md §5)."""

    width: int = 800
    height: int = 600
    spp_per_pass: int = 4  # samples folded into the film per jit step
    passes: int = 25
    seed: int = 0
    tonemap: str = "linear"  # "linear" (CUDA) or "gamma" (MCRT display)
    accum: str = "linear"  # "linear" (CUDA) or "gamma" (MCRT's biased
    # gamma-space running mean, rtx.hlsl:400-404)
    step_dir: Optional[str] = None  # per-pass PNG dumps when set
    preview: bool = False  # with step_dir: also keep `preview.png`
    # (latest frame, atomically replaced) + a self-refreshing
    # `index.html` — open it in any browser for a live progressive
    # view. The stand-in for the reference's cvShowImage /
    # swapchain present (CUTracer.cu:392-393, GraphicsRTX.cpp:211-230).
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0  # passes between checkpoints (0 = off)
    regen: bool = False  # regenerating-wavefront passes (render/
    # regen.py): lanes restart the next sample the step their path
    # dies, so RR-mode tails keep ~100% occupancy instead of decaying
    # over 16 static segments. Unbiased, deterministic, but not
    # pass-exact vs the scan integrator for spp_per_pass > 1. Traces
    # the whole frame as one wavefront (ignores config.ray_chunk).


def _pass_step(
    scene: ScenePack,
    camera: Camera,
    film: Film,
    key: jax.Array,
    accel=None,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    accum: str = "linear",
) -> Film:
    """One progressive pass: mean of ``spp`` full-frame sample batches,
    folded into the film with weight ``spp``."""

    def one_sample(acc, i):
        # Planar (3, H, W) accumulation: keeps the pixel axes on the
        # vector lanes inside the hot per-sample loop.
        img = render_rows_planar(
            scene,
            camera,
            jax.random.fold_in(key, i),
            width,
            height,
            0,
            height,
            config,
            accel,
        )
        return acc + img, None

    total, _ = jax.lax.scan(
        one_sample, jnp.zeros((3, height, width), jnp.float32), jnp.arange(spp)
    )
    update = film_update_gamma if accum == "gamma" else film_update
    return update(film, total.transpose(1, 2, 0) / spp, float(spp))


def _pass_step_regen(
    scene: ScenePack,
    camera: Camera,
    film: Film,
    key: jax.Array,
    accel=None,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    accum: str = "linear",
) -> Film:
    """One regenerating-wavefront pass (RenderSettings.regen): the mean
    of ``spp`` samples/pixel from one persistent wavefront, folded into
    the film with weight ``spp``."""
    from .regen import render_regen_planar

    img = render_regen_planar(
        scene, camera, key, width, height, spp, config, accel
    )
    update = film_update_gamma if accum == "gamma" else film_update
    return update(film, img.transpose(1, 2, 0), float(spp))


class Renderer:
    """Progressive path-tracing driver bound to one scene + camera."""

    def __init__(
        self,
        scene: ScenePack,
        camera: Camera,
        config: TraceConfig = TraceConfig(),
        settings: RenderSettings = RenderSettings(),
        log: Optional[RenderLog] = None,
        accel=None,
    ):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.settings = settings
        self.accel = accel
        self.log = log or RenderLog(enabled=False)
        s = settings
        self._step = jax.jit(
            functools.partial(
                _pass_step_regen if s.regen else _pass_step,
                width=s.width,
                height=s.height,
                spp=s.spp_per_pass,
                config=config,
                accum=s.accum,
            ),
            donate_argnums=(2,),
        )
        self.film = Film.zeros(s.height, s.width)
        self.pass_idx = 0
        if s.checkpoint_path and os.path.exists(s.checkpoint_path):
            self.load_checkpoint(s.checkpoint_path)

    # -- checkpoint / resume --------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        np.savez(
            tmp if tmp.endswith(".npz") else tmp,
            color=np.asarray(self.film.color),
            weight=np.asarray(self.film.weight),
            m2=np.asarray(self.film.m2),
            seed=np.int64(self.settings.seed),
            pass_idx=np.int64(self.pass_idx),
        )
        # np.savez appends .npz to names without it
        src = tmp if tmp.endswith(".npz") else tmp + ".npz"
        os.replace(src, path)

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as z:
            if int(z["seed"]) != self.settings.seed:
                raise ValueError(
                    f"checkpoint seed {int(z['seed'])} != settings seed "
                    f"{self.settings.seed}"
                )
            self.film = Film(
                color=jnp.asarray(z["color"]),
                weight=jnp.asarray(z["weight"]),
                m2=jnp.asarray(z["m2"]) if "m2" in z else jnp.zeros(()),
            )
            self.pass_idx = int(z["pass_idx"])

    # -- rendering ------------------------------------------------------------

    def render(self, passes: Optional[int] = None) -> Film:
        """Run progressive passes (resuming from ``self.pass_idx``)."""
        s = self.settings
        n = passes if passes is not None else s.passes
        base_key = make_key(s.seed)
        end = self.pass_idx + n
        while self.pass_idx < end:
            k = jax.random.fold_in(base_key, self.pass_idx)
            t0 = time.perf_counter()
            self.film = self._step(self.scene, self.camera, self.film, k, self.accel)
            if self.log.enabled:
                # Fence only when the per-pass timing is consumed: the
                # loop itself needs no sync (each step consumes the
                # previous film on device).
                self.film.color.block_until_ready()
            dt = time.perf_counter() - t0
            self.pass_idx += 1
            if self.log.enabled:
                # The film weight is deterministic (spp × passes folded
                # in), so don't fetch it; m2 is the only device→host
                # scalar.
                weight = s.spp_per_pass * self.pass_idx
                m2 = float(np.asarray(self.film.m2))
                self.log.batch(
                    spp=s.spp_per_pass,
                    width=s.width,
                    height=s.height,
                    seconds=dt,
                    pass_idx=self.pass_idx,
                    total_spp=float(weight),
                    # Online noise estimate: std of the film mean
                    # (Welford over pass means) — SURVEY.md §5 metrics.
                    noise=round(float(np.sqrt(m2)) / max(weight, 1e-20), 6),
                )
            if s.step_dir:
                img_u8 = self.image_u8()
                save_png(
                    os.path.join(s.step_dir, f"step{self.pass_idx - 1:06d}.png"),
                    img_u8,
                )
                if s.preview:
                    self._write_preview(img_u8)
            if (
                s.checkpoint_path
                and s.checkpoint_every
                and self.pass_idx % s.checkpoint_every == 0
            ):
                self.save_checkpoint(s.checkpoint_path)
        if s.checkpoint_path:
            self.save_checkpoint(s.checkpoint_path)
        return self.film

    def _write_preview(self, img_u8: np.ndarray) -> None:
        """Live progressive preview: atomically replace preview.png and
        (once) write a self-refreshing viewer page next to it."""
        s = self.settings
        tmp = os.path.join(s.step_dir, ".preview.tmp.png")
        save_png(tmp, img_u8)
        os.replace(tmp, os.path.join(s.step_dir, "preview.png"))
        index = os.path.join(s.step_dir, "index.html")
        if not os.path.exists(index):
            with open(index, "w") as f:
                f.write(
                    "<!doctype html><title>montecarlopathtracer"
                    " preview</title>\n"
                    "<body style='margin:0;background:#111;display:flex;"
                    "align-items:center;justify-content:center;"
                    "height:100vh'>\n"
                    "<img id=v style='image-rendering:pixelated;"
                    "max-width:100vw;max-height:100vh'>\n"
                    "<script>const v=document.getElementById('v');\n"
                    "setInterval(()=>{v.src='preview.png?'+Date.now()},"
                    "1000);v.src='preview.png';</script>\n"
                )

    def image_u8(self) -> np.ndarray:
        if self.settings.accum == "gamma":
            # The film already stores gamma-encoded values.
            return tonemap_identity(self.film.color)
        if self.settings.tonemap == "gamma":
            return tonemap_gamma(self.film.color)
        return tonemap_linear(self.film.color)

    def save_png(self, path: str) -> None:
        save_png(path, self.image_u8())
