"""Flat device-array scene representation (the device data contract).

The reference marshals the parsed OBJ into four flat GPU buffers
(vertex / normal / triangle / geometry+material —
`CVMCTracer/CVMCTracer/CUDA/CUTracer.cu:225-314`, and structured buffers
t0–t4 in `MCRT/QuinEngine/RTX/ShaderResource.hpp:41-215`). Here the
equivalent is a :class:`ScenePack` pytree of jnp arrays that is
**replicated** per device (rays/samples are what shard), with triangle
count padded to a multiple of 128 so every kernel sees static,
block-aligned shapes.

Differences from the reference by design:

- materials are stored per-*triangle* (``tri_mat``), which subsumes both
  the CUDA per-group material (CUTracer.cu:300-308) and the MCRT
  per-triangle matId (ShaderResource.hpp:87-126). CUDA group semantics
  (whole group shades with its first triangle's material) are applied at
  pack build time via ``material_mode="group"``.
- a ``tri_valid`` mask marks padding triangles so padded lanes can never
  produce hits (instead of dynamic triangle counts, which would defeat
  XLA's static shapes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .objio import ObjModel, read_obj

LANE = 128  # the triangle axis is padded to a multiple of this, so
# kernels see static, block-aligned shapes.


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ScenePack:
    """Scene as flat arrays. All float arrays are float32.

    Shapes: V vertices, N normals, T triangles (padded), M materials.
    """

    vertices: jnp.ndarray  # f32[V, 3]
    normals: jnp.ndarray  # f32[N, 3]
    tri_v: jnp.ndarray  # i32[T, 3] vertex indices
    tri_n: jnp.ndarray  # i32[T, 3] normal indices
    tri_mat: jnp.ndarray  # i32[T] material ids
    tri_valid: jnp.ndarray  # bool[T] False for padding
    mat_ka: jnp.ndarray  # f32[M, 3] emission (emitter iff any > 0)
    mat_kd: jnp.ndarray  # f32[M, 3] diffuse albedo
    mat_ks: jnp.ndarray  # f32[M, 3] specular albedo
    mat_ns: jnp.ndarray  # f32[M] Phong exponent (specular iff > 1)
    mat_tr: jnp.ndarray  # f32[M] transparency (refractive iff > 0)
    mat_ni: jnp.ndarray  # f32[M] index of refraction

    # -- pytree protocol ------------------------------------------------------

    def tree_flatten(self):
        children = (
            self.vertices,
            self.normals,
            self.tri_v,
            self.tri_n,
            self.tri_mat,
            self.tri_valid,
            self.mat_ka,
            self.mat_kd,
            self.mat_ks,
            self.mat_ns,
            self.mat_tr,
            self.mat_ni,
        )
        return children, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- derived quantities ---------------------------------------------------

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v.shape[0])

    def triangle_vertices(self):
        """Gather triangle corner positions: three f32[T, 3] arrays."""
        a = self.vertices[self.tri_v[:, 0]]
        b = self.vertices[self.tri_v[:, 1]]
        c = self.vertices[self.tri_v[:, 2]]
        return a, b, c

    def triangle_normals(self):
        """Gather per-corner shading normals: three f32[T, 3] arrays."""
        n0 = self.normals[self.tri_n[:, 0]]
        n1 = self.normals[self.tri_n[:, 1]]
        n2 = self.normals[self.tri_n[:, 2]]
        return n0, n1, n2

    def aabb(self) -> tuple:
        """Scene bounds over valid triangles (host helper)."""
        a, b, c = self.triangle_vertices()
        pts = jnp.concatenate([a, b, c], axis=0)
        valid = jnp.tile(self.tri_valid, 3)[:, None]
        big = jnp.float32(3.4e38)
        lo = jnp.min(jnp.where(valid, pts, big), axis=0)
        hi = jnp.max(jnp.where(valid, pts, -big), axis=0)
        return lo, hi


def scene_pack_from_model(
    model: ObjModel,
    material_mode: str = "group",
    pad_to: int = LANE,
) -> ScenePack:
    """Flatten a parsed :class:`ObjModel` into a :class:`ScenePack`.

    ``material_mode="group"`` reproduces the CUDA backend's contract:
    every triangle in a named group shades with the material of the
    group's *first* triangle (CUTracer.cu:300-308).
    ``material_mode="triangle"`` keeps per-triangle materials as parsed
    (MCRT contract, ShaderResource.hpp:87-126).
    """
    # Real triangles are indices >= 1 (slot 0 is the parser's dummy).
    tri_rows = []
    for name, tri_ids in sorted(model.groups.items()):
        if not tri_ids:
            continue
        if material_mode == "group":
            group_mat = model.triangles[tri_ids[0]].material
            mats = [group_mat] * len(tri_ids)
        elif material_mode == "triangle":
            mats = [model.triangles[t].material for t in tri_ids]
        else:
            raise ValueError(f"unknown material_mode: {material_mode!r}")
        for tid, mat in zip(tri_ids, mats):
            tri = model.triangles[tid]
            tri_rows.append((tri.v, tri.n, mat))

    T = len(tri_rows)
    Tp = max(_round_up(max(T, 1), pad_to), pad_to)

    tri_v = np.zeros((Tp, 3), dtype=np.int32)
    tri_n = np.zeros((Tp, 3), dtype=np.int32)
    tri_mat = np.zeros((Tp,), dtype=np.int32)
    tri_valid = np.zeros((Tp,), dtype=bool)
    for i, (v, n, m) in enumerate(tri_rows):
        tri_v[i] = v
        tri_n[i] = n
        tri_mat[i] = m
        tri_valid[i] = True

    mats = model.materials
    mat_ka = np.asarray([m.Ka for m in mats], dtype=np.float32)
    mat_kd = np.asarray([m.Kd for m in mats], dtype=np.float32)
    mat_ks = np.asarray([m.Ks for m in mats], dtype=np.float32)
    mat_ns = np.asarray([m.Ns for m in mats], dtype=np.float32)
    mat_tr = np.asarray([m.Tr for m in mats], dtype=np.float32)
    mat_ni = np.asarray([m.Ni for m in mats], dtype=np.float32)

    return ScenePack(
        vertices=jnp.asarray(model.vertex_array()),
        normals=jnp.asarray(model.normal_array()),
        tri_v=jnp.asarray(tri_v),
        tri_n=jnp.asarray(tri_n),
        tri_mat=jnp.asarray(tri_mat),
        tri_valid=jnp.asarray(tri_valid),
        mat_ka=jnp.asarray(mat_ka),
        mat_kd=jnp.asarray(mat_kd),
        mat_ks=jnp.asarray(mat_ks),
        mat_ns=jnp.asarray(mat_ns),
        mat_tr=jnp.asarray(mat_tr),
        mat_ni=jnp.asarray(mat_ni),
    )


def scene_pack_from_arrays(
    vertices: np.ndarray,  # f32[V, 3]
    normals: np.ndarray,  # f32[N, 3]
    tri_v: np.ndarray,  # i32[T, 3]
    tri_n: np.ndarray,  # i32[T, 3]
    tri_mat: np.ndarray,  # i32[T]
    materials: dict,  # {"Ka": [M,3], "Kd": [M,3], "Ks": [M,3],
    #                    "Ns": [M], "Tr": [M], "Ni": [M]}
    pad_to: int = LANE,
) -> ScenePack:
    """Assemble a :class:`ScenePack` directly from raw numpy arrays —
    the fast path for procedurally generated meshes (no per-triangle
    Python objects). Pads the triangle axis and fills ``tri_valid``."""
    T = int(tri_v.shape[0])
    Tp = max(_round_up(max(T, 1), pad_to), pad_to)
    tv = np.zeros((Tp, 3), np.int32)
    tn = np.zeros((Tp, 3), np.int32)
    tm = np.zeros((Tp,), np.int32)
    valid = np.zeros((Tp,), bool)
    tv[:T] = tri_v
    tn[:T] = tri_n
    tm[:T] = tri_mat
    valid[:T] = True
    return ScenePack(
        vertices=jnp.asarray(vertices, jnp.float32),
        normals=jnp.asarray(normals, jnp.float32),
        tri_v=jnp.asarray(tv),
        tri_n=jnp.asarray(tn),
        tri_mat=jnp.asarray(tm),
        tri_valid=jnp.asarray(valid),
        mat_ka=jnp.asarray(materials["Ka"], jnp.float32),
        mat_kd=jnp.asarray(materials["Kd"], jnp.float32),
        mat_ks=jnp.asarray(materials["Ks"], jnp.float32),
        mat_ns=jnp.asarray(materials["Ns"], jnp.float32),
        mat_tr=jnp.asarray(materials["Tr"], jnp.float32),
        mat_ni=jnp.asarray(materials["Ni"], jnp.float32),
    )


def load_obj_scene(
    path: str,
    material_mode: str = "group",
    pad_to: int = LANE,
) -> ScenePack:
    """Parse an OBJ file and flatten it in one call."""
    return scene_pack_from_model(
        read_obj(path), material_mode=material_mode, pad_to=pad_to
    )
