"""Stackless KD-tree traversal as a masked `lax.while_loop`.

The reference traverses its KD-tree with a 64-deep per-thread stack and
data-dependent control flow (rtx.hlsl:151-209). In a wavefront of
arrays, per-lane stacks and divergent branches are the enemy; the flat layout built in
`accel.kdtree` is pre-order with **skip links**, so traversal is a
single monotone cursor per ray:

    hit AABB & interior → cursor + 1      (descend into left child)
    hit AABB & leaf     → test leaf tris, then cursor = skip
    miss AABB           → cursor = skip   (jump over the subtree)

All R rays advance in lockstep inside one `lax.while_loop`; lanes that
finished (cursor == N) are masked. Leaf triangle tests reuse the same
unit-triangle transform math as the brute-force oracle
(`ops.intersect`), one (ray, triangle) pair per lane per inner step.

AABB test semantics mirror rtx.hlsl:84-142 (slab test with explicit
zero-direction guards, early-out against the current closest t); we add
the ``t_max ≥ 0`` rejection the reference omits — it only prunes nodes
strictly behind the ray, which can never produce a valid hit
(triangle accept requires t > 0, CUTracer.cu:82).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import Hit
from ..accel.kdtree import FlatKDTree

_LEAF_MAX = 64


class KDArrays(NamedTuple):
    """Device-resident flat KD-tree (a pytree of jnp arrays)."""

    node_lo: jnp.ndarray  # f32[N, 3]
    node_hi: jnp.ndarray  # f32[N, 3]
    node_skip: jnp.ndarray  # i32[N]
    leaf_start: jnp.ndarray  # i32[N]
    leaf_count: jnp.ndarray  # i32[N]
    leaf_tris: jnp.ndarray  # i32[L]

    @classmethod
    def from_flat(cls, flat: FlatKDTree) -> "KDArrays":
        return cls(
            node_lo=jnp.asarray(flat.node_lo),
            node_hi=jnp.asarray(flat.node_hi),
            node_skip=jnp.asarray(flat.node_skip),
            leaf_start=jnp.asarray(flat.leaf_start),
            leaf_count=jnp.asarray(flat.leaf_count),
            leaf_tris=jnp.asarray(flat.leaf_tris),
        )


def _slab_test(o, d, lo, hi, tmax_cap):
    """Vectorized slab test (R lanes). Returns bool[R]."""
    zero = d == 0.0
    inside = (o >= lo) & (o <= hi)
    inv = jnp.where(zero, 1.0, 1.0 / jnp.where(zero, 1.0, d))
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = jnp.where(zero, jnp.where(inside, -jnp.inf, jnp.inf), jnp.minimum(t0, t1))
    tf = jnp.where(zero, jnp.where(inside, jnp.inf, -jnp.inf), jnp.maximum(t0, t1))
    t_near = jnp.max(tn, axis=-1)
    t_far = jnp.min(tf, axis=-1)
    return (t_near <= t_far) & (t_near <= tmax_cap) & (t_far >= 0.0)


def intersect_kdtree(
    kd: KDArrays,
    m: jnp.ndarray,  # f32[T, 3, 3] triangle transforms
    m_a: jnp.ndarray,  # f32[T, 3]
    tri_valid: jnp.ndarray,  # bool[T]
    origins: jnp.ndarray,  # f32[R, 3]
    dirs: jnp.ndarray,  # f32[R, 3]
) -> Hit:
    """Closest hit via KD traversal. Matches `intersect_brute` up to
    floating-point ordering of the min-reduction."""
    R = origins.shape[0]
    N = kd.node_lo.shape[0]
    m_rows = m.reshape(-1, 9)  # f32[T, 9]

    def leaf_tests(carry, cursor, start, count):
        tmin, best_id, best_beta, best_gamma = carry

        def one(k, c):
            tmin, best_id, best_beta, best_gamma = c
            in_leaf = k < count
            tid = kd.leaf_tris[jnp.clip(start + k, 0, kd.leaf_tris.shape[0] - 1)]
            tid = jnp.where(in_leaf, tid, 0)
            ok_tri = in_leaf & (tid >= 0) & tri_valid[jnp.maximum(tid, 0)]
            tid = jnp.maximum(tid, 0)
            mw = m_rows[tid].reshape(R, 3, 3)
            ma = m_a[tid]
            hp = jax.lax.Precision.HIGHEST
            o_p = jnp.einsum("rij,rj->ri", mw, origins, precision=hp) - ma
            d_p = jnp.einsum("rij,rj->ri", mw, dirs, precision=hp)
            dz = d_p[:, 2]
            safe = jnp.abs(dz) > 1e-12
            t = jnp.where(safe, -o_p[:, 2] / jnp.where(safe, dz, 1.0), -1.0)
            beta = o_p[:, 0] + t * d_p[:, 0]
            gamma = o_p[:, 1] + t * d_p[:, 1]
            accept = (
                ok_tri
                & (beta > 0.0)
                & (gamma > 0.0)
                & (beta + gamma < 1.0)
                & (t > 0.0)
                & (t < tmin)
            )
            tmin = jnp.where(accept, t, tmin)
            best_id = jnp.where(accept, tid, best_id)
            best_beta = jnp.where(accept, beta, best_beta)
            best_gamma = jnp.where(accept, gamma, best_gamma)
            return (tmin, best_id, best_beta, best_gamma)

        return jax.lax.fori_loop(0, _LEAF_MAX, one, carry)

    def cond(state):
        cursor, *_ = state
        return jnp.any(cursor < N)

    def body(state):
        cursor, tmin, best_id, best_beta, best_gamma = state
        node = jnp.clip(cursor, 0, N - 1)
        active = cursor < N
        lo = kd.node_lo[node]
        hi = kd.node_hi[node]
        skip = kd.node_skip[node]
        start = kd.leaf_start[node]
        count = jnp.where(active, kd.leaf_count[node], 0)

        box_hit = active & _slab_test(origins, dirs, lo, hi, tmin)
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf

        carry = (tmin, best_id, best_beta, best_gamma)
        tmin, best_id, best_beta, best_gamma = leaf_tests(
            carry, cursor, start, jnp.where(do_leaf, count, 0)
        )

        next_cursor = jnp.where(
            box_hit & ~is_leaf, cursor + 1, jnp.where(active, skip, cursor)
        )
        return (next_cursor, tmin, best_id, best_beta, best_gamma)

    state = (
        jnp.zeros((R,), jnp.int32),
        jnp.full((R,), jnp.inf, jnp.float32),
        jnp.full((R,), -1, jnp.int32),
        jnp.zeros((R,), jnp.float32),
        jnp.zeros((R,), jnp.float32),
    )
    cursor, tmin, best_id, best_beta, best_gamma = jax.lax.while_loop(
        cond, body, state
    )
    miss = best_id < 0
    point = origins + jnp.where(miss, 0.0, tmin)[:, None] * dirs
    return Hit(
        tri_id=best_id,
        t=tmin,
        beta=best_beta,
        gamma=best_gamma,
        point=point,
    )
