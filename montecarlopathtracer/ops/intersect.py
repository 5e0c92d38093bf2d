"""Ray/triangle-soup intersection as batched linear algebra.

The reference tests each ray against each triangle with four 3×3
Cramer's-rule determinants per pair inside a scalar loop
(`CVMCTracer/CVMCTracer/CUDA/CUTracer.cu:44-96`, same math via 4×4
determinants in `MCRT/QuinEngine/Shader/rtx.hlsl:160-201`). Instead we
precompute a
per-triangle affine "unit triangle" transform once per scene:

    M_t = inv([b-a, c-a, n])           (columns; n = (b-a)×(c-a))

which maps world space so the triangle becomes the unit right triangle
in the z=0 plane. For a ray (o, d):

    o' = M_t (o - a)        d' = M_t d
    t  = -o'_z / d'_z
    β  = o'_x + t d'_x      γ = o'_y + t d'_y

and the reference's accept test carries over verbatim:
β > 0, γ > 0, β + γ < 1, t > 0, t < t_min (CUTracer.cu:82). The
barycentric convention matches the reference exactly: the hit point is
``a (1-β-γ) + b β + c γ`` (its Cramer system solves
``a - o = β (a-b) + γ (a-c) + t d``).

Why this shape: o' and d' for *all* rays × *all* triangles are two
matmuls ``[R, 3] @ [3, 3T]`` — dense, static-shaped work for XLA. This
module is the oracle; `ops.nearest` runs the same math per (ray,
triangle) pair inside one GPU kernel without writing the ``[R, T]``
intermediate to memory.

Everything here is differentiable w.r.t. vertex positions: the
transforms are built with `jnp` (3×3 adjugate inverse) from the vertex
array, and β/γ/t flow through them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

_DET_EPS = 1e-12


class Hit(NamedTuple):
    """Closest-hit record for a wavefront of R rays.

    ``tri_id < 0`` means miss (reference: ``objID == -1``,
    CUTracer.cu:47). β/γ are the barycentric weights of vertices b and c
    (CUTracer.cu:79-80); ``point`` is the world-space hit position.
    """

    tri_id: jnp.ndarray  # i32[R]
    t: jnp.ndarray  # f32[R] (inf on miss)
    beta: jnp.ndarray  # f32[R]
    gamma: jnp.ndarray  # f32[R]
    point: jnp.ndarray  # f32[R, 3]


def triangle_transforms(
    a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-triangle unit-triangle transforms.

    Returns ``(m, m_a)`` with ``m`` f32[T, 3, 3] and ``m_a = m @ a``
    f32[T, 3], so ``o' = o @ m^T - m_a`` and ``d' = d @ m^T``.

    Degenerate (zero-area / padding) triangles get a near-singular
    system; their determinant is clamped so the inverse stays finite,
    and the produced (β, γ, t) then fail the accept test. Differentiable
    w.r.t. the vertex positions.
    """
    e_b = b - a  # maps to (1, 0, 0)
    e_c = c - a  # maps to (0, 1, 0)
    n = jnp.cross(e_b, e_c)  # maps to (0, 0, 1); |n| ~ triangle area

    # E = [e_b, e_c, n] as columns; M = E^{-1} via the adjugate.
    # det(E) = n · n  (since n ⟂ e_b, e_c).
    det = jnp.sum(n * n, axis=-1)
    safe_det = jnp.where(jnp.abs(det) < _DET_EPS, 1.0, det)
    inv_det = 1.0 / safe_det

    # Rows of adj(E): cross products of the other two columns.
    r0 = jnp.cross(e_c, n)  # adj row for the e_b coordinate
    r1 = jnp.cross(n, e_b)  # adj row for the e_c coordinate
    r2 = n  # row for the n coordinate: n·n/det = 1
    m = jnp.stack([r0, r1, r2], axis=-2) * inv_det[..., None, None]
    m_a = jnp.einsum("tij,tj->ti", m, a, precision=jax.lax.Precision.HIGHEST)
    return m, m_a


def _closest_hit_from_primed(
    o_p: jnp.ndarray,  # f32[R, T, 3]
    d_p: jnp.ndarray,  # f32[R, T, 3]
    tri_valid: jnp.ndarray,  # bool[T]
    t_min_init: jnp.ndarray,  # f32[R] current closest t
):
    """Reduce primed coordinates to per-ray closest hit over this chunk."""
    dz = d_p[..., 2]
    # Parallel rays (dz == 0) must not hit: force t negative.
    safe_dz = jnp.where(jnp.abs(dz) < _DET_EPS, 1.0, dz)
    t = jnp.where(jnp.abs(dz) < _DET_EPS, -1.0, -o_p[..., 2] / safe_dz)
    beta = o_p[..., 0] + t * d_p[..., 0]
    gamma = o_p[..., 1] + t * d_p[..., 1]

    ok = (
        (beta > 0.0)
        & (gamma > 0.0)
        & (beta + gamma < 1.0)
        & (t > 0.0)
        & (t < t_min_init[:, None])
        & tri_valid[None, :]
    )
    t_masked = jnp.where(ok, t, jnp.inf)
    idx = jnp.argmin(t_masked, axis=1)  # i32[R] chunk-local winner
    r = jnp.arange(t.shape[0])
    return (
        idx,
        t_masked[r, idx],
        beta[r, idx],
        gamma[r, idx],
    )


def intersect_brute(
    m: jnp.ndarray,  # f32[T, 3, 3] triangle transforms
    m_a: jnp.ndarray,  # f32[T, 3]
    tri_valid: jnp.ndarray,  # bool[T]
    origins: jnp.ndarray,  # f32[R, 3]
    dirs: jnp.ndarray,  # f32[R, 3]
    t_chunk: Optional[int] = None,
) -> Hit:
    """Closest hit of every ray against every triangle (brute force).

    This is the lax *oracle* implementation — semantics identical to the
    reference's brute-force loop (CUTracer.cu:44-96) but expressed as
    two ``[R, 3] @ [3, 3T]`` matmuls plus a masked min-reduction.
    ``t_chunk`` bounds the materialized ``[R, chunk]`` intermediate by
    scanning triangle chunks with a running closest-hit carry.
    """
    T = m.shape[0]
    R = origins.shape[0]
    if t_chunk is None or t_chunk >= T:
        t_chunk = T
    assert T % t_chunk == 0, (T, t_chunk)
    n_chunks = T // t_chunk

    # [T, 3, 3] -> [3, 3T] laid out so o @ w gives o'[r, t*3 + i].
    w = jnp.transpose(m, (0, 1, 2)).reshape(T * 3, 3).T  # f32[3, 3T]

    def chunk_slice(x, i):
        return jax.lax.dynamic_slice_in_dim(x, i * t_chunk, t_chunk, axis=0)

    def body(carry, i):
        best_t, best_idx, best_beta, best_gamma = carry
        w_c = jax.lax.dynamic_slice_in_dim(w, i * t_chunk * 3, t_chunk * 3, axis=1)
        ma_c = chunk_slice(m_a, i)
        valid_c = chunk_slice(tri_valid, i)
        # Explicit full-f32 contraction: a reduced-precision matmul
        # (bf16 or TF32 inputs) moves t by far more than the 0.01
        # self-intersection epsilon at scene scale and flips winners
        # near triangle edges.
        hp = jax.lax.Precision.HIGHEST
        o_p = jnp.matmul(origins, w_c, precision=hp).reshape(
            R, t_chunk, 3
        ) - ma_c[None, :, :]
        d_p = jnp.matmul(dirs, w_c, precision=hp).reshape(R, t_chunk, 3)
        idx, t, beta, gamma = _closest_hit_from_primed(o_p, d_p, valid_c, best_t)
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        best_idx = jnp.where(
            better, (idx + i * t_chunk).astype(jnp.int32), best_idx
        )
        best_beta = jnp.where(better, beta, best_beta)
        best_gamma = jnp.where(better, gamma, best_gamma)
        return (best_t, best_idx, best_beta, best_gamma), None

    ft = jnp.result_type(origins, m)  # f32, or f64 for a float64 oracle
    init = (
        jnp.full((R,), jnp.inf, ft),
        jnp.full((R,), -1, jnp.int32),
        jnp.zeros((R,), ft),
        jnp.zeros((R,), ft),
    )
    if n_chunks == 1:
        (best_t, best_idx, best_beta, best_gamma), _ = body(init, 0)
    else:
        (best_t, best_idx, best_beta, best_gamma), _ = jax.lax.scan(
            body, init, jnp.arange(n_chunks)
        )

    miss = jnp.isinf(best_t)
    tri_id = jnp.where(miss, -1, best_idx).astype(jnp.int32)
    point = origins + jnp.where(miss, 0.0, best_t)[:, None] * dirs
    return Hit(tri_id=tri_id, t=best_t, beta=best_beta, gamma=best_gamma, point=point)
