"""Differentiable Monte Carlo path tracer in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of
pw1316/MonteCarloPathTracer (progressive Cornell-box path tracing over
triangle meshes with diffuse / Phong-specular / Fresnel-refractive
materials, a SAH KD-tree acceleration structure, and two termination
strategies), redesigned as array programs:

- rays are a *batch axis*, not threads: the integrator is a wavefront
  over ``[R]``-shaped arrays inside ``jit``;
- ray/triangle intersection tests rays against precomputed
  per-triangle affine (unit-triangle) transforms; on the GPU a Pallas
  Triton kernel keeps the (R, T) product on chip and returns only the
  winner, whose hit XLA recomputes differentiably;
- sample batches and pixels shard over a ``jax.sharding.Mesh`` with the
  scene replicated per chip and the film / parameter gradients combined
  by ``psum``;
- the whole forward pass is differentiable (detached sampling), giving
  pixel gradients w.r.t. vertices, albedos and emitter radiance.

Reference parity map: see SURVEY.md. Reference behavior citations in
docstrings use ``path:line`` into /root/reference.
"""

from .version import __version__

from .scene.scene import ScenePack, load_obj_scene, scene_pack_from_model
from .scene.camera import Camera, camera_for_scene
from .scene.objio import ObjModel, read_obj
from .render.integrator import TraceConfig, trace_radiance, render_sample_batch
from .render.film import Film, film_update, tonemap_linear, tonemap_gamma
from .render.renderer import Renderer, RenderSettings
from .models import cornell

__all__ = [
    "__version__",
    "ScenePack",
    "load_obj_scene",
    "scene_pack_from_model",
    "Camera",
    "camera_for_scene",
    "ObjModel",
    "read_obj",
    "TraceConfig",
    "trace_radiance",
    "render_sample_batch",
    "Film",
    "film_update",
    "tonemap_linear",
    "tonemap_gamma",
    "Renderer",
    "RenderSettings",
    "cornell",
]
