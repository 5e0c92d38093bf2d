"""Intersector tests: closed-form cases + equivalence with a direct
Cramer's-rule reference implementation (CUTracer.cu:44-96 semantics)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import jax as _jax
from montecarlopathtracer.ops.intersect import (
    triangle_transforms as _triangle_transforms,
    intersect_brute as _intersect_brute,
)

# Jit everything: eager op-by-op dispatch is ~1s/op on this host.
triangle_transforms = _jax.jit(_triangle_transforms)
intersect_brute = _jax.jit(_intersect_brute, static_argnames=("t_chunk",))


def _cramer_reference(a, b, c, o, d):
    """Direct NumPy port of the reference's per-pair determinant test,
    used as the oracle-of-the-oracle. Returns (hit, t, beta, gamma)."""
    A = np.stack([a - b, a - c, d], axis=-1)
    detA = np.linalg.det(A)
    if abs(detA) < 1e-20:
        return False, np.inf, 0.0, 0.0
    beta = np.linalg.det(np.stack([a - o, a - c, d], axis=-1)) / detA
    gamma = np.linalg.det(np.stack([a - b, a - o, d], axis=-1)) / detA
    t = np.linalg.det(np.stack([a - b, a - c, a - o], axis=-1)) / detA
    hit = beta + gamma < 1 and beta > 0 and gamma > 0 and t > 0
    return hit, t, beta, gamma


def _pack(tris):
    a = jnp.asarray([t[0] for t in tris], jnp.float32)
    b = jnp.asarray([t[1] for t in tris], jnp.float32)
    c = jnp.asarray([t[2] for t in tris], jnp.float32)
    m, m_a = triangle_transforms(a, b, c)
    valid = jnp.ones((len(tris),), bool)
    return m, m_a, valid


def test_single_triangle_hit_and_barycentrics():
    tri = ([0, 0, 0], [1, 0, 0], [0, 1, 0])
    m, m_a, valid = _pack([tri])
    o = jnp.asarray([[0.25, 0.25, 1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    hit = intersect_brute(m, m_a, valid, o, d)
    assert int(hit.tri_id[0]) == 0
    np.testing.assert_allclose(float(hit.t[0]), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(hit.beta[0]), 0.25, rtol=1e-5)
    np.testing.assert_allclose(float(hit.gamma[0]), 0.25, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(hit.point[0]), [0.25, 0.25, 0.0], atol=1e-6
    )


def test_miss_outside_and_behind():
    tri = ([0, 0, 0], [1, 0, 0], [0, 1, 0])
    m, m_a, valid = _pack([tri])
    o = jnp.asarray([[2.0, 2.0, 1.0], [0.25, 0.25, 1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]], jnp.float32)
    hit = intersect_brute(m, m_a, valid, o, d)
    assert int(hit.tri_id[0]) == -1
    assert int(hit.tri_id[1]) == -1  # triangle behind the ray
    assert np.isinf(float(hit.t[0]))


def test_parallel_ray_no_hit():
    tri = ([0, 0, 0], [1, 0, 0], [0, 1, 0])
    m, m_a, valid = _pack([tri])
    o = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    d = jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32)
    hit = intersect_brute(m, m_a, valid, o, d)
    assert int(hit.tri_id[0]) == -1


def test_closest_of_two():
    tris = [
        ([-5, -5, -2], [5, -5, -2], [0, 5, -2]),
        ([-5, -5, -1], [5, -5, -1], [0, 5, -1]),
    ]
    m, m_a, valid = _pack(tris)
    o = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    hit = intersect_brute(m, m_a, valid, o, d)
    assert int(hit.tri_id[0]) == 1
    np.testing.assert_allclose(float(hit.t[0]), 1.0, rtol=1e-5)


def test_invalid_mask_blocks_hits():
    tri = ([0, 0, 0], [1, 0, 0], [0, 1, 0])
    m, m_a, _ = _pack([tri])
    valid = jnp.zeros((1,), bool)
    o = jnp.asarray([[0.25, 0.25, 1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    hit = intersect_brute(m, m_a, valid, o, d)
    assert int(hit.tri_id[0]) == -1


def test_degenerate_triangle_no_hit_no_nan():
    tris = [
        ([0, 0, 0], [0, 0, 0], [0, 0, 0]),  # degenerate
        ([-5, -5, -1], [5, -5, -1], [0, 5, -1]),
    ]
    m, m_a, valid = _pack(tris)
    o = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    hit = intersect_brute(m, m_a, valid, o, d)
    assert int(hit.tri_id[0]) == 1
    assert np.isfinite(float(hit.beta[0]))


@pytest.mark.parametrize("t_chunk", [None, 32])
def test_random_soup_matches_cramer_reference(t_chunk):
    rng = np.random.default_rng(7)
    T, R = 32, 64
    a = rng.uniform(-3, 3, (T, 3)).astype(np.float32)
    b = a + rng.uniform(-1.5, 1.5, (T, 3)).astype(np.float32)
    c = a + rng.uniform(-1.5, 1.5, (T, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    m, m_a = triangle_transforms(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    valid = jnp.ones((T,), bool)
    hit = intersect_brute(
        m, m_a, valid, jnp.asarray(o), jnp.asarray(d), t_chunk=t_chunk
    )

    for r in range(R):
        best_t, best_i = np.inf, -1
        for t_i in range(T):
            ok, t, beta, gamma = _cramer_reference(
                a[t_i].astype(np.float64),
                b[t_i].astype(np.float64),
                c[t_i].astype(np.float64),
                o[r].astype(np.float64),
                d[r].astype(np.float64),
            )
            if ok and t < best_t:
                best_t, best_i = t, t_i
        assert int(hit.tri_id[r]) == best_i, r
        if best_i >= 0:
            # f32 unit-transform vs f64 Cramer: skinny random triangles
            # can be ill-conditioned, so allow a loose tolerance here;
            # well-conditioned scene geometry agrees much tighter (see
            # closed-form tests above at 1e-5).
            np.testing.assert_allclose(float(hit.t[r]), best_t, rtol=3e-2)


def test_transforms_differentiable_wrt_vertices():
    tri_a = jnp.asarray([[0.0, 0.0, 0.0]])
    tri_b = jnp.asarray([[1.0, 0.0, 0.0]])
    tri_c = jnp.asarray([[0.0, 1.0, 0.0]])
    o = jnp.asarray([[0.25, 0.25, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])

    def hit_t(az):
        a = tri_a.at[0, 2].set(az)
        m, m_a = triangle_transforms(a, tri_b, tri_c)
        hit = intersect_brute(m, m_a, jnp.ones((1,), bool), o, d)
        return hit.t[0]

    g = jax.grad(hit_t)(jnp.float32(0.0))
    # Moving vertex a up by dz moves the hit plane: t = 1 - dz * (1 - β - γ)
    np.testing.assert_allclose(float(g), -(1 - 0.25 - 0.25), rtol=1e-4)
