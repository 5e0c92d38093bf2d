"""Nearest-hit intersection as one Pallas Triton kernel.

The lax oracle (`ops.intersect.intersect_brute`) writes the primed ray
coordinates of every (ray, triangle) pair to device memory as two
``[R, T, 3]`` f32 arrays before its accept test, so it is bound by
memory bandwidth. This kernel keeps the whole product on chip, in the
shape of the reference's per-pixel CUDA loop (CUTracer.cu:44-96):

- each program owns a block of ``_BLOCK_R`` rays, whose origins and
  directions stay in registers;
- a ``fori_loop`` streams the packed triangle table (``[12, T_pad]``
  f32: the rows of ``m`` and ``m_a``, component-major so every load is
  contiguous) in blocks of ``_BLOCK_T`` triangles; the table is small
  enough to stay in L1/L2 (37 KB for the 768-triangle Cornell box,
  3.9 MB for the 82k-triangle bunny);
- o' and d' are f32 multiply-adds on the CUDA cores. There is no
  ``pl.dot``: a K=3 contraction gives the tensor cores nothing, and a
  TF32 selection would flip winners near triangle edges;
- the accept test is the oracle's, parallel-ray guard included
  (`ops.intersect._closest_hit_from_primed`), and each ray keeps a
  running (best t, best index) with ties going to the smaller index,
  as ``jnp.argmin`` does.

The kernel returns the winner index only. `refine_hit` recomputes the
winner's t/β/γ/point in exact f32 with plain XLA, so with the index
under ``stop_gradient`` ordinary AD gives the a.e. gradient of the
nearest-hit function: no custom VJP is needed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .intersect import Hit, _DET_EPS

# Measured on an H100 (PERF.md): among 9 shapes from 32×32 to 512×4,
# 128 rays × 8 triangles with 4 warps was fastest on both the 768- and
# the 82k-triangle scene.
_BLOCK_R = 128  # rays per program
_BLOCK_T = 8  # triangles per loop step
_NUM_WARPS = 4
_NUM_STAGES = 2


def _sds(shape, dtype, like):
    """ShapeDtypeStruct that inherits the varying-manual-axes type of
    ``like``, which shard_map's ``check_vma`` typecheck requires of a
    kernel's outputs inside a mesh body."""
    vma = getattr(jax.typeof(like), "vma", None)
    if vma:
        return jax.ShapeDtypeStruct(shape, dtype, vma=vma)
    return jax.ShapeDtypeStruct(shape, dtype)


def pack_triangles(
    m: jnp.ndarray, m_a: jnp.ndarray, tri_valid: jnp.ndarray, block: int
) -> jnp.ndarray:
    """The kernel's triangle table: f32[12, T_pad], rows
    ``m[:, 0, :], m[:, 1, :], m[:, 2, :], m_a`` component by component,
    with T padded to a multiple of ``block``. Invalid and padding
    triangles are all-zero columns: their d'_z is 0, which the
    parallel-ray guard rejects."""
    T = m.shape[0]
    v = tri_valid.astype(m.dtype)
    rows = jnp.concatenate(
        [(m * v[:, None, None]).reshape(T, 9), m_a * v[:, None]], axis=1
    ).T  # (12, T)
    pad = (-T) % block
    return jnp.pad(rows, ((0, 0), (0, pad)))


def _nearest_kernel(pos_ref, dir_ref, tri_ref, idx_ref, *, n_tblocks):
    r0 = pl.program_id(0) * _BLOCK_R
    rs = pl.ds(r0, _BLOCK_R)
    ox, oy, oz = (pos_ref[k, rs][:, None] for k in range(3))
    dx, dy, dz = (dir_ref[k, rs][:, None] for k in range(3))
    lane = jax.lax.broadcasted_iota(jnp.int32, (_BLOCK_R, _BLOCK_T), 1)

    def body(j, carry):
        best_t, best_i = carry
        t0 = j * _BLOCK_T
        ts = pl.ds(t0, _BLOCK_T)
        w = [tri_ref[k, ts][None, :] for k in range(12)]

        def primed(k, x, y, z):
            return w[3 * k] * x + w[3 * k + 1] * y + w[3 * k + 2] * z

        opx = primed(0, ox, oy, oz) - w[9]
        opy = primed(1, ox, oy, oz) - w[10]
        opz = primed(2, ox, oy, oz) - w[11]
        dpx = primed(0, dx, dy, dz)
        dpy = primed(1, dx, dy, dz)
        dpz = primed(2, dx, dy, dz)
        dz_ok = jnp.abs(dpz) >= _DET_EPS
        t = jnp.where(dz_ok, -opz / jnp.where(dz_ok, dpz, 1.0), -1.0)
        beta = opx + t * dpx
        gamma = opy + t * dpy
        ok = (beta > 0.0) & (gamma > 0.0) & (beta + gamma < 1.0) & (t > 0.0)
        t_ok = jnp.where(ok, t, jnp.inf)
        c_min = jnp.min(t_ok, axis=1)
        # Smallest index among the block's minima (argmin's tie rule);
        # the strict < below keeps an earlier block's tie.
        c_idx = jnp.min(
            jnp.where(t_ok == c_min[:, None], lane, _BLOCK_T), axis=1
        )
        better = c_min < best_t
        return (
            jnp.where(better, c_min, best_t),
            jnp.where(better, c_idx + t0, best_i),
        )

    best_t, best_i = jax.lax.fori_loop(
        0,
        n_tblocks,
        body,
        (
            jnp.full((_BLOCK_R,), jnp.inf, jnp.float32),
            jnp.full((_BLOCK_R,), -1, jnp.int32),
        ),
    )
    idx_ref[...] = jnp.where(best_t < jnp.inf, best_i, -1)


@functools.partial(jax.jit, static_argnames=("interpret",))
def nearest_index(
    m: jnp.ndarray,  # f32[T, 3, 3] triangle transforms
    m_a: jnp.ndarray,  # f32[T, 3]
    tri_valid: jnp.ndarray,  # bool[T]
    pos3: jnp.ndarray,  # f32[3, R] ray origins
    dir3: jnp.ndarray,  # f32[3, R] ray directions
    interpret: bool = False,
) -> jnp.ndarray:
    """Index of the nearest accepted triangle for each ray (-1 = miss),
    i32[R]. Not differentiable (an argmin): callers hold it under
    ``stop_gradient`` and recompute the hit with `refine_hit`.

    Compiles for a CUDA GPU. ``interpret=True`` runs the same kernel
    in the Pallas interpreter (CPU tests); without it any other
    platform is an error rather than a silent fallback."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "nearest_index compiles for a CUDA GPU only; on "
            f"{jax.default_backend()!r} pass interpret=True or use the "
            "'brute' intersector"
        )
    R = pos3.shape[1]
    Rp = -(-R // _BLOCK_R) * _BLOCK_R
    # Padding rays have a zero direction: d'_z = 0 everywhere → miss.
    pos3 = jnp.pad(pos3, ((0, 0), (0, Rp - R)))
    dir3 = jnp.pad(dir3, ((0, 0), (0, Rp - R)))
    table = pack_triangles(m, m_a, tri_valid, _BLOCK_T)
    idx = pl.pallas_call(
        functools.partial(
            _nearest_kernel, n_tblocks=table.shape[1] // _BLOCK_T
        ),
        grid=(Rp // _BLOCK_R,),
        in_specs=[
            pl.BlockSpec(pos3.shape, lambda i: (0, 0)),
            pl.BlockSpec(dir3.shape, lambda i: (0, 0)),
            pl.BlockSpec(table.shape, lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((_BLOCK_R,), lambda i: (i,)),
        out_shape=_sds((Rp,), jnp.int32, pos3),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name="mcpt_nearest",
    )(pos3, dir3, table)
    return idx[:R]


def refine_hit(
    m: jnp.ndarray,
    m_a: jnp.ndarray,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    tri_id: jnp.ndarray,
) -> Hit:
    """Differentiably recompute (t, β, γ, point) for chosen triangles.

    ``tri_id`` comes from the kernel (or any selector) and is treated as
    a constant; gradients flow through the transform of the selected
    triangle only — exactly the a.e.-gradient of the nearest-hit
    function.
    """
    tid = jnp.maximum(tri_id, 0)
    mw = m[tid]  # (R, 3, 3)
    ma = m_a[tid]  # (R, 3)
    hp = jax.lax.Precision.HIGHEST
    o_p = jnp.einsum("rij,rj->ri", mw, origins, precision=hp) - ma
    d_p = jnp.einsum("rij,rj->ri", mw, dirs, precision=hp)
    dz = d_p[:, 2]
    safe = jnp.abs(dz) > _DET_EPS
    t = jnp.where(safe, -o_p[:, 2] / jnp.where(safe, dz, 1.0), jnp.inf)
    beta = o_p[:, 0] + t * d_p[:, 0]
    gamma = o_p[:, 1] + t * d_p[:, 1]
    miss = tri_id < 0
    t = jnp.where(miss, jnp.inf, t)
    point = origins + jnp.where(miss, 0.0, t)[:, None] * dirs
    return Hit(
        tri_id=tri_id,
        t=t,
        beta=jnp.where(miss, 0.0, beta),
        gamma=jnp.where(miss, 0.0, gamma),
        point=point,
    )
