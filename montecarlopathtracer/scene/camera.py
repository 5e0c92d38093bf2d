"""Pinhole camera: basis construction and batched ray generation.

Reproduces the reference's two camera conventions behind one dataclass:

- CUDA backend: 60° horizontal FOV pinhole with aspect folded in as
  ``(H/W)``, per-sample jitter of ±1 px, camera basis built inline from
  eye/forward/up (CUTracer.cu:189-211, 347-374).
- HLSL backend: inverse-projection ray with ``fovy = π/4`` and ±0.5 px
  jitter (rtx.hlsl:384-398, GraphicsRTX.cpp:182-184).

Ray generation is a pure vectorized function of pixel index
arrays — it produces the ``[R, 3]`` wavefront arrays directly, no
per-thread scalar code.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp


def _normalize(v: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Camera:
    """Camera with orthonormal basis and per-axis tangent half-FOVs.

    The camera ray through pixel (x, y) with jitter (jx, jy) is::

        d_cam = ((2 (x+jx) / W - 1) * tan_half_x,
                 (1 - 2 (y+jy) / H) * tan_half_y,
                 -1)
        d_world = normalize(right * d_cam.x + up * d_cam.y + forward)

    which matches CUTracer.cu:199-211 with ``tan_half_x = tan(fov/2)``
    and ``tan_half_y = tan(fov/2) * H / W``.
    """

    eye: jnp.ndarray  # f32[3]
    forward: jnp.ndarray  # f32[3], unit
    up: jnp.ndarray  # f32[3], unit
    right: jnp.ndarray  # f32[3], unit
    tan_half_x: jnp.ndarray  # f32[] tangent of horizontal half-FOV
    tan_half_y: jnp.ndarray  # f32[] tangent of vertical half-FOV
    jitter: float = 1.0  # half-width of the pixel jitter in pixels

    def tree_flatten(self):
        children = (
            self.eye,
            self.forward,
            self.up,
            self.right,
            self.tan_half_x,
            self.tan_half_y,
        )
        return children, (self.jitter,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, jitter=aux[0])

    @classmethod
    def look(
        cls,
        eye,
        forward,
        up,
        *,
        width: int,
        height: int,
        fov_x_deg: float = 60.0,
        jitter: float = 1.0,
    ) -> "Camera":
        """Build the orthonormal basis the way the reference does:
        ``right = forward × up``, ``up = right × forward``
        (CUTracer.cu:347-374)."""
        eye = jnp.asarray(eye, jnp.float32)
        fwd = _normalize(jnp.asarray(forward, jnp.float32))
        upv = jnp.asarray(up, jnp.float32)
        right = _normalize(jnp.cross(fwd, upv))
        upv = _normalize(jnp.cross(right, fwd))
        tan_half = jnp.float32(math.tan(math.radians(fov_x_deg) / 2.0))
        return cls(
            eye=eye,
            forward=fwd,
            up=upv,
            right=right,
            tan_half_x=tan_half,
            tan_half_y=tan_half * (height / width),
            jitter=jitter,
        )

    def generate_rays_soa(
        self,
        xs: jnp.ndarray,
        ys: jnp.ndarray,
        jx: jnp.ndarray,
        jy: jnp.ndarray,
        width: int,
        height: int,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Batched primary rays, component-major.

        ``xs``/``ys`` are pixel column/row indices (row 0 = image top,
        matching the reference framebuffer layout, CUTracer.cu:181-184);
        ``jx``/``jy`` are uniform in [-1, 1) and scaled by ``jitter``.
        Returns (origins f32[3, R], directions f32[3, R] unit),
        component-major.
        """
        bx = xs.astype(jnp.float32) + jx * self.jitter
        by = ys.astype(jnp.float32) + jy * self.jitter
        dx = (2.0 * bx / width - 1.0) * self.tan_half_x
        dy = (1.0 - 2.0 * by / height) * self.tan_half_y
        d = (
            self.right[:, None] * dx[None, :]
            + self.up[:, None] * dy[None, :]
            + self.forward[:, None]
        )
        d = d / jnp.sqrt(jnp.sum(d * d, axis=0, keepdims=True))
        o = jnp.broadcast_to(self.eye[:, None], d.shape)
        return o, d

    def generate_rays(
        self,
        xs: jnp.ndarray,
        ys: jnp.ndarray,
        jx: jnp.ndarray,
        jy: jnp.ndarray,
        width: int,
        height: int,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """AoS wrapper over :meth:`generate_rays_soa`:
        (origins f32[R, 3], directions f32[R, 3] unit)."""
        o, d = self.generate_rays_soa(xs, ys, jx, jy, width, height)
        return o.T, d.T


def camera_for_mcrt(width: int, height: int) -> Camera:
    """The MCRT backend's camera (GraphicsRTX.cpp:173-184): eye (0,5,17)
    looking at (0,5,16) (−z), up +Y, *vertical* FOV π/4 with aspect on
    the horizontal axis, ±0.5 px jitter (rtx.hlsl:385-386)."""
    tan_half_y = math.tan(math.pi / 8.0)
    cam = Camera.look(
        (0.0, 5.0, 17.0),
        (0.0, 0.0, -1.0),
        (0.0, 1.0, 0.0),
        width=width,
        height=height,
        fov_x_deg=60.0,  # overwritten below
        jitter=0.5,
    )
    return dataclasses.replace(
        cam,
        tan_half_y=jnp.float32(tan_half_y),
        tan_half_x=jnp.float32(tan_half_y * width / height),
    )


def camera_for_scene(scene_id: int, width: int, height: int) -> Camera:
    """The reference's hardcoded per-scene cameras (CUTracer.cu:347-374):
    scene 1 eye=(0,5,17), scene 2 eye=(0,5,23), both looking −z, 60° FOV,
    ±1 px jitter.

    Scene 3 has no reference camera (scene03 is never wired into
    main.cpp, which only has RENDER_1/2) and, unlike scene01, its box is
    *closed* on all six sides (wall6 spans z=+5), so a camera outside
    the box sees black. We place it inside, near the +z wall:
    eye=(0,5,4.8) looking −z — with a 90° horizontal FOV, fitted
    against the committed result3.png by a grid search over
    (fov, eye_y, eye_z) minimizing scale-fitted image MAE (r4:
    fov 90 ≈ 0.0674 vs 0.098 at the scene-1 style 60°; the goldens
    clearly used a wider lens inside the closed box).
    """
    if scene_id == 3:
        eye = (0.0, 5.0, 4.8)
        fov = 90.0
    else:
        eye = (0.0, 5.0, 17.0) if scene_id == 1 else (0.0, 5.0, 23.0)
        fov = 60.0
    return Camera.look(
        eye,
        (0.0, 0.0, -1.0),
        (0.0, 1.0, 0.0),
        width=width,
        height=height,
        fov_x_deg=fov,
        jitter=1.0,
    )
