"""KD-tree builder + stackless traversal tests: structural validation
and exact agreement with the brute-force oracle (SURVEY.md §7 step 3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlopathtracer.accel.kdtree import (
    build_kdtree,
    flatten_kdtree,
    validate_kdtree,
    dump_obj,
    LEAF_MAX,
)
from montecarlopathtracer.ops.intersect import (
    triangle_transforms,
    intersect_brute,
)
from montecarlopathtracer.ops.traverse import KDArrays, intersect_kdtree
from montecarlopathtracer.models import cornell

_intersect_brute = jax.jit(intersect_brute)
_intersect_kd = jax.jit(intersect_kdtree)
_transforms = jax.jit(triangle_transforms)


def _random_soup(T, seed=0, spread=3.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-spread, spread, (T, 3)).astype(np.float32)
    b = a + rng.uniform(-1.0, 1.0, (T, 3)).astype(np.float32)
    c = a + rng.uniform(-1.0, 1.0, (T, 3)).astype(np.float32)
    return a, b, c


def test_small_node_becomes_leaf_or_sah_split():
    a, b, c = _random_soup(8)
    root = build_kdtree(a, b, c)
    tlo = np.minimum(np.minimum(a, b), c)
    thi = np.maximum(np.maximum(a, b), c)
    seen = validate_kdtree(root, tlo, thi, 8)
    assert seen.all(), "every triangle must be reachable from a leaf"


def test_large_node_median_split_and_coverage():
    T = 500  # > LEAF_MAX forces median splits at the top
    a, b, c = _random_soup(T, seed=3)
    root = build_kdtree(a, b, c)
    assert root.axis >= 0, "root with 500 tris must split"
    tlo = np.minimum(np.minimum(a, b), c)
    thi = np.maximum(np.maximum(a, b), c)
    seen = validate_kdtree(root, tlo, thi, T)
    assert seen.all()

    flat = flatten_kdtree(root)
    assert flat.num_nodes >= 3
    # skip links are strictly increasing targets within bounds
    assert (flat.node_skip > np.arange(flat.num_nodes)).all()
    assert (flat.node_skip <= flat.num_nodes).all()
    # leaves hold at most LEAF_MAX triangles unless the depth cap hit
    assert flat.leaf_count.max() <= max(LEAF_MAX, 1)


@pytest.mark.parametrize("T,seed", [(60, 1), (300, 2)])
def test_traversal_matches_brute_force(T, seed):
    a, b, c = _random_soup(T, seed=seed)
    root = build_kdtree(a, b, c)
    flat = flatten_kdtree(root)
    kd = KDArrays.from_flat(flat)

    m, m_a = _transforms(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    valid = jnp.ones((T,), bool)

    rng = np.random.default_rng(seed + 100)
    R = 256
    o = jnp.asarray(rng.uniform(-4, 4, (R, 3)), jnp.float32)
    d = rng.normal(size=(R, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True), jnp.float32)

    hb = _intersect_brute(m, m_a, valid, o, d)
    hk = _intersect_kd(kd, m, m_a, valid, o, d)

    # The two paths evaluate the same math with different op orderings
    # (matmul vs gathered einsum), so strict-inequality accepts can flip
    # for rays grazing an edge; require near-total agreement and tight t
    # agreement on the agreeing hits.
    tb, tk = np.asarray(hb.tri_id), np.asarray(hk.tri_id)
    agree = tb == tk
    assert agree.mean() >= 0.995, f"only {agree.mean():.1%} agreement"
    hit_mask = agree & (tb >= 0)
    np.testing.assert_allclose(
        np.asarray(hb.t)[hit_mask], np.asarray(hk.t)[hit_mask], rtol=1e-3
    )


def test_traversal_on_cornell_scene():
    scene, cam = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=32, height=32
    )
    a, b, c = scene.triangle_vertices()
    valid_np = np.asarray(scene.tri_valid)
    root = build_kdtree(np.asarray(a), np.asarray(b), np.asarray(c), valid_np)
    flat = flatten_kdtree(root)
    kd = KDArrays.from_flat(flat)
    m, m_a = _transforms(a, b, c)

    R = 32 * 32
    pix = jnp.arange(R)
    # Jitter off pixel centers: centered rays on this axis-aligned box
    # graze quad diagonals exactly, where strict-inequality accepts are
    # compiler-rounding dependent.
    o, d = cam.generate_rays(
        pix % 32,
        pix // 32,
        jnp.full((R,), 0.137),
        jnp.full((R,), 0.271),
        32,
        32,
    )
    hb = _intersect_brute(m, m_a, scene.tri_valid, o, d)
    hk = _intersect_kd(kd, m, m_a, scene.tri_valid, o, d)
    tb, tk = np.asarray(hb.tri_id), np.asarray(hk.tri_id)
    agree = tb == tk
    assert agree.mean() >= 0.995, f"only {agree.mean():.1%} agreement"


def test_dump_obj(tmp_path):
    a, b, c = _random_soup(100, seed=5)
    root = build_kdtree(a, b, c)
    path = str(tmp_path / "kdtree.obj")
    dump_obj(root, path)
    text = open(path).read()
    assert text.startswith("g default")
    assert "v " in text and "f " in text
