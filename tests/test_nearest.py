"""The Triton nearest-hit kernel (ops/nearest.py).

On the CPU the kernel runs in the Pallas interpreter and is compared
with the lax oracle `intersect_brute`. Winners must agree; where the
two float pipelines can legitimately disagree (a ray through a shared
edge or vertex), the other winner must be a near tie in t or the ray
must graze an edge. Tests marked ``gpu`` compile the kernel for the
card and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlopathtracer.models import cornell
from montecarlopathtracer.ops.intersect import (
    intersect_brute,
    triangle_transforms,
)
from montecarlopathtracer.ops.nearest import (
    _BLOCK_R,
    _BLOCK_T,
    nearest_index,
    pack_triangles,
    refine_hit,
)


def _soup(key, n_tris):
    k1, k2 = jax.random.split(key)
    a = jax.random.uniform(k1, (n_tris, 3), minval=-1.0, maxval=1.0)
    e = jax.random.normal(k2, (2, n_tris, 3)) * 0.5
    return a, a + e[0], a + e[1]


def _rays(key, n, spread=1.5):
    k1, k2 = jax.random.split(key)
    o = jax.random.uniform(k1, (n, 3), minval=-spread, maxval=spread)
    d = jax.random.normal(k2, (n, 3))
    return o, d / jnp.linalg.norm(d, axis=1, keepdims=True)


def _assert_same_tie_or_graze(m, m_a, o, d, idx, ref):
    """Winners agree; or both hit at t within 1e-4·t of each other; or
    the ray grazes an edge (barycentric distance ≤ 1e-4) of one of the
    two candidates, where two f32 pipelines may round either way."""
    idx = np.asarray(idx)
    ref_id = np.asarray(ref.tri_id)
    diff = idx != ref_id
    if diff.any():
        sel = np.where(diff)[0]

        def refined(ids):
            h = refine_hit(m, m_a, o[sel], d[sel], jnp.asarray(ids[sel]))
            b, g = np.asarray(h.beta), np.asarray(h.gamma)
            e = np.minimum(np.minimum(b, g), 1.0 - b - g)
            return np.asarray(h.t), np.where(ids[sel] >= 0, np.abs(e), np.inf)

        (t0, e0), (t1, e1) = refined(idx), refined(ref_id)
        tie = np.abs(t0 - t1) <= 1e-4 * np.abs(t1)
        graze = np.minimum(e0, e1) <= 1e-4
        assert np.all(tie | graze), (t0, t1, e0, e1)
    return diff.mean()


@pytest.mark.parametrize(
    "n_rays,n_tris",
    [
        (1, 1),
        (5, 3),
        (_BLOCK_R - 1, _BLOCK_T - 1),
        (_BLOCK_R + 1, _BLOCK_T + 1),
        (2 * _BLOCK_R + 3, 3 * _BLOCK_T + 5),
        (200, 128),
    ],
)
def test_nearest_matches_brute_off_block_sizes(n_rays, n_tris):
    key = jax.random.key(n_rays * 1000 + n_tris)
    a, b, c = _soup(key, n_tris)
    m, m_a = triangle_transforms(a, b, c)
    valid = jnp.ones((n_tris,), bool)
    o, d = _rays(jax.random.fold_in(key, 1), n_rays)
    idx = nearest_index(m, m_a, valid, o.T, d.T, interpret=True)
    ref = intersect_brute(m, m_a, valid, o, d)
    assert idx.shape == (n_rays,) and idx.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref.tri_id))


@pytest.mark.parametrize("pattern", ["middle", "all"])
def test_nearest_skips_invalid_triangles(pattern):
    key = jax.random.key(3)
    n = 40
    a, b, c = _soup(key, n)
    m, m_a = triangle_transforms(a, b, c)
    if pattern == "middle":
        valid = jnp.arange(n) % 3 != 1
    else:
        valid = jnp.zeros((n,), bool)
    o, d = _rays(jax.random.fold_in(key, 2), 150)
    idx = np.asarray(nearest_index(m, m_a, valid, o.T, d.T, interpret=True))
    ref = intersect_brute(m, m_a, valid, o, d)
    np.testing.assert_array_equal(idx, np.asarray(ref.tri_id))
    assert not np.isin(idx, np.where(~np.asarray(valid))[0]).any()


def test_pack_triangles_pads_with_rejecting_columns():
    a, b, c = _soup(jax.random.key(4), 5)
    m, m_a = triangle_transforms(a, b, c)
    valid = jnp.asarray([True, False, True, True, False])
    table = np.asarray(pack_triangles(m, m_a, valid, _BLOCK_T))
    assert table.shape == (12, _BLOCK_T)
    np.testing.assert_array_equal(table[:, [1, 4]], 0.0)
    np.testing.assert_array_equal(table[:, 5:], 0.0)
    np.testing.assert_array_equal(table[:9, 0], np.asarray(m[0]).ravel())
    np.testing.assert_array_equal(table[9:, 2], np.asarray(m_a[2]))


def test_nearest_rays_parallel_to_triangles_miss():
    # Triangles in z = const planes; rays travelling inside such planes.
    n = 8
    z = jnp.linspace(-1.0, 1.0, n)
    a = jnp.stack([jnp.zeros(n), jnp.zeros(n), z], 1)
    b = jnp.stack([jnp.ones(n), jnp.zeros(n), z], 1)
    c = jnp.stack([jnp.zeros(n), jnp.ones(n), z], 1)
    m, m_a = triangle_transforms(a, b, c)
    valid = jnp.ones((n,), bool)
    o = jnp.stack([jnp.full(n, -1.0), jnp.full(n, 0.2), z], 1)
    d = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]), (n, 1))
    idx = np.asarray(nearest_index(m, m_a, valid, o.T, d.T, interpret=True))
    ref = intersect_brute(m, m_a, valid, o, d)
    np.testing.assert_array_equal(idx, np.asarray(ref.tri_id))
    np.testing.assert_array_equal(idx, -1)


def test_nearest_rays_through_edges_and_vertices():
    # A 4×4 grid of unit quads (two triangles each) at z = 0; rays hit
    # it straight down through grid vertices, edge midpoints and
    # diagonals, where two to six triangles meet.
    tris = []
    for i in range(4):
        for j in range(4):
            p00 = (i, j, 0.0)
            p10 = (i + 1, j, 0.0)
            p01 = (i, j + 1, 0.0)
            p11 = (i + 1, j + 1, 0.0)
            tris += [(p00, p10, p11), (p00, p11, p01)]
    t = jnp.asarray(tris, jnp.float32)
    m, m_a = triangle_transforms(t[:, 0], t[:, 1], t[:, 2])
    valid = jnp.ones((t.shape[0],), bool)
    g = np.arange(0.0, 4.01, 0.5)
    xs, ys = np.meshgrid(g, g)
    o = jnp.asarray(
        np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 2.0)], 1),
        jnp.float32,
    )
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (o.shape[0], 1))
    idx = nearest_index(m, m_a, valid, o.T, d.T, interpret=True)
    ref = intersect_brute(m, m_a, valid, o, d)
    np.testing.assert_array_equal(np.asarray(idx) >= 0, np.asarray(ref.tri_id) >= 0)
    _assert_same_tie_or_graze(m, m_a, o, d, idx, ref)


def test_nearest_all_miss_wavefront():
    a, b, c = _soup(jax.random.key(5), 50)
    m, m_a = triangle_transforms(a, b, c)
    valid = jnp.ones((50,), bool)
    o, _ = _rays(jax.random.key(6), 90)
    o = o + 10.0  # outside the soup's box, looking further away
    d = jnp.tile(jnp.asarray([[0.6, 0.0, 0.8]]), (90, 1))
    idx = np.asarray(nearest_index(m, m_a, valid, o.T, d.T, interpret=True))
    np.testing.assert_array_equal(idx, -1)


def test_nearest_bounce_wavefront_inside_box():
    scene, _ = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=8, height=8
    )
    a, b, c = scene.triangle_vertices()
    m, m_a = triangle_transforms(a, b, c)
    lo, hi = (np.asarray(x) for x in scene.aabb())
    key = jax.random.key(8)
    u = jax.random.uniform(key, (300, 3))
    o = jnp.asarray(lo + (hi - lo) * (0.05 + 0.9 * np.asarray(u)), jnp.float32)
    _, d = _rays(jax.random.fold_in(key, 1), 300)
    idx = nearest_index(m, m_a, scene.tri_valid, o.T, d.T, interpret=True)
    ref = intersect_brute(m, m_a, scene.tri_valid, o, d)
    # The box is open only toward the camera: most bounces hit.
    assert (np.asarray(ref.tri_id) >= 0).mean() > 0.8
    assert _assert_same_tie_or_graze(m, m_a, o, d, idx, ref) <= 0.01


def test_nearest_raises_on_cpu_without_interpret():
    a, b, c = _soup(jax.random.key(9), 4)
    m, m_a = triangle_transforms(a, b, c)
    o, d = _rays(jax.random.key(10), 4)
    with pytest.raises(RuntimeError, match="GPU"):
        nearest_index(m, m_a, jnp.ones((4,), bool), o.T, d.T)


def test_refined_nearest_hit_matches_brute():
    a, b, c = _soup(jax.random.key(11), 30)
    m, m_a = triangle_transforms(a, b, c)
    valid = jnp.ones((30,), bool)
    o, d = _rays(jax.random.key(12), 100)
    idx = nearest_index(m, m_a, valid, o.T, d.T, interpret=True)
    hit = refine_hit(m, m_a, o, d, idx)
    ref = intersect_brute(m, m_a, valid, o, d)
    np.testing.assert_array_equal(np.asarray(hit.tri_id), np.asarray(ref.tri_id))
    h = np.asarray(ref.tri_id) >= 0
    for f in ("t", "beta", "gamma"):
        np.testing.assert_allclose(
            np.asarray(getattr(hit, f))[h], np.asarray(getattr(ref, f))[h],
            rtol=1e-5, atol=1e-6,
        )
    np.testing.assert_allclose(np.asarray(hit.point), np.asarray(ref.point),
                               rtol=1e-5, atol=1e-5)
    assert np.isinf(np.asarray(hit.t)[~h]).all()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_refine_hit_gradient_matches_finite_difference(axis):
    """d(t + β + γ)/d(vertex a) through the winner recompute, the index
    held fixed, against central differences in float64."""
    a = np.asarray([[0.1, -0.2, 1.0]], np.float64)
    b = np.asarray([[1.2, 0.1, 1.1]], np.float64)
    c = np.asarray([[-0.1, 1.3, 0.9]], np.float64)
    o = jnp.asarray([[0.2, 0.3, -1.0]], jnp.float32)
    d = jnp.asarray([[0.05, 0.02, 1.0]], jnp.float32)
    d = d / jnp.linalg.norm(d)
    idx = jnp.asarray([0], jnp.int32)

    def f(av):
        m, m_a = triangle_transforms(av, jnp.asarray(b, av.dtype),
                                     jnp.asarray(c, av.dtype))
        h = refine_hit(m, m_a, o.astype(av.dtype), d.astype(av.dtype), idx)
        return h.t[0] + h.beta[0] + h.gamma[0]

    g = jax.grad(f)(jnp.asarray(a, jnp.float32))[0, axis]
    eps = 1e-3
    with jax.enable_x64(True):
        e = np.zeros((1, 3))
        e[0, axis] = eps
        fd = (f(jnp.asarray(a + e)) - f(jnp.asarray(a - e))) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-3, atol=1e-4)


@pytest.mark.gpu
def test_nearest_compiled_matches_brute_on_gpu(gpu):
    scene, camera = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=64, height=48
    )
    a, b, c = scene.triangle_vertices()
    m, m_a = triangle_transforms(a, b, c)
    xs = jnp.arange(64 * 48) % 64
    ys = jnp.arange(64 * 48) // 64
    z = jnp.zeros(64 * 48)
    pos3, dir3 = camera.generate_rays_soa(xs, ys, z, z, 64, 48)
    idx = nearest_index(m, m_a, scene.tri_valid, pos3, dir3)
    with jax.default_matmul_precision("highest"):
        ref = intersect_brute(m, m_a, scene.tri_valid, pos3.T, dir3.T)
    assert _assert_same_tie_or_graze(m, m_a, pos3.T, dir3.T, idx, ref) <= 1e-3


@pytest.mark.gpu
def test_kdtree_walk_runs_on_gpu(gpu):
    from montecarlopathtracer.accel.kdtree import build_flat_kdtree
    from montecarlopathtracer.ops.traverse import KDArrays, intersect_kdtree

    scene, camera = cornell.cornell_box(width=32, height=24)
    a, b, c = scene.triangle_vertices()
    flat = build_flat_kdtree(
        np.asarray(a), np.asarray(b), np.asarray(c),
        np.asarray(scene.tri_valid),
    )
    m, m_a = triangle_transforms(a, b, c)
    xs = jnp.arange(32 * 24) % 32
    ys = jnp.arange(32 * 24) // 32
    z = jnp.zeros(32 * 24)
    pos3, dir3 = camera.generate_rays_soa(xs, ys, z, z, 32, 24)
    hit = intersect_kdtree(
        KDArrays.from_flat(flat), m, m_a, scene.tri_valid, pos3.T, dir3.T
    )
    ref = intersect_brute(m, m_a, scene.tri_valid, pos3.T, dir3.T)
    assert (np.asarray(hit.tri_id) == np.asarray(ref.tri_id)).mean() > 0.999
