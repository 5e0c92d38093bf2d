"""Wavefront integrator tests: termination semantics, emitter handling,
determinism, and a smoke render of the procedural Cornell box."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlopathtracer.models import cornell
from montecarlopathtracer.models.cornell import _Builder
from montecarlopathtracer.scene.scene import scene_pack_from_model
from montecarlopathtracer.render.integrator import (
    TraceConfig,
    trace_radiance_jit as trace_radiance,
    render_sample_batch_jit as render_sample_batch,
)

CFG = TraceConfig(max_depth=4, ray_chunk=0, illum=10.0)


def _emitter_wall_scene(ka=0.5, kd=0.0):
    b = _Builder()
    m = b.add_material("wall", Ka=(ka, ka, ka) if ka else (0, 0, 0), Kd=(kd,) * 3)
    b.add_quad(
        "wall", m, (-5, -5, -2), (5, -5, -2), (5, 5, -2), (-5, 5, -2), (0, 0, 1)
    )
    return scene_pack_from_model(b.model)


def test_emitter_hit_returns_ka_times_illum():
    scene = _emitter_wall_scene(ka=0.5)
    # NB: (0, 0) would land exactly on the quad's shared diagonal edge,
    # which the strict barycentric test rejects (CUTracer.cu:82) — same
    # behavior as the reference. Offset to the triangle interior.
    o = jnp.asarray([[0.3, 0.2, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    rad = trace_radiance(scene, o, d, jax.random.key(0), config=CFG)
    np.testing.assert_allclose(np.asarray(rad[0]), [5.0, 5.0, 5.0], rtol=1e-5)


def test_miss_returns_black():
    scene = _emitter_wall_scene(ka=0.5)
    o = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)  # away from the wall
    rad = trace_radiance(scene, o, d, jax.random.key(0), config=CFG)
    np.testing.assert_allclose(np.asarray(rad[0]), [0.0, 0.0, 0.0], atol=1e-7)


def test_illum_scale_config():
    scene = _emitter_wall_scene(ka=0.5)
    o = jnp.asarray([[0.3, 0.2, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    cfg = TraceConfig(mode="rr", rr_depth=5, illum=1.0, ray_chunk=0)
    rad = trace_radiance(scene, o, d, jax.random.key(0), config=cfg)
    np.testing.assert_allclose(np.asarray(rad[0]), [0.5, 0.5, 0.5], rtol=1e-5)


def _closed_box_scene(kd=1.0, ka_roof=2.0):
    """A closed diffuse box with an emissive ceiling."""
    b = _Builder()
    white = b.add_material("white", Kd=(kd,) * 3)
    light = b.add_material("light", Ka=(ka_roof,) * 3)
    s = 4.0
    b.add_quad("floor", white, (-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s), (0, 1, 0))
    b.add_quad("roof", light, (-s, 8, -s), (s, 8, -s), (s, 8, s), (-s, 8, s), (0, -1, 0))
    b.add_quad("back", white, (-s, 0, -s), (s, 0, -s), (s, 8, -s), (-s, 8, -s), (0, 0, 1))
    b.add_quad("front", white, (-s, 0, s), (-s, 8, s), (s, 8, s), (s, 0, s), (0, 0, -1))
    b.add_quad("left", white, (-s, 0, -s), (-s, 8, -s), (-s, 8, s), (-s, 0, s), (1, 0, 0))
    b.add_quad("right", white, (s, 0, -s), (s, 0, s), (s, 8, s), (s, 8, -s), (-1, 0, 0))
    return scene_pack_from_model(b.model)


def test_fixed_vs_rr_estimators_agree():
    """RR with 1/p compensation is unbiased: both modes must estimate
    the same radiance on a closed box (SURVEY.md §7 hard parts)."""
    scene = _closed_box_scene()
    R = 4096
    o = jnp.tile(jnp.asarray([[0.0, 4.0, 0.0]], jnp.float32), (R, 1))
    k = jax.random.key(3)
    theta = jax.random.uniform(k, (R,)) * 2 * np.pi
    phi = jnp.arccos(jax.random.uniform(jax.random.fold_in(k, 1), (R,)) * 2 - 1)
    d = jnp.stack(
        [jnp.sin(phi) * jnp.cos(theta), jnp.cos(phi), jnp.sin(phi) * jnp.sin(theta)],
        axis=-1,
    )
    cfg_fixed = TraceConfig(mode="fixed", max_depth=12, illum=1.0, ray_chunk=0)
    cfg_rr = TraceConfig(mode="rr", rr_depth=6, illum=1.0, ray_chunk=0)
    r_fixed = np.asarray(trace_radiance(scene, o, d, jax.random.key(11), config=cfg_fixed))
    r_rr = np.asarray(trace_radiance(scene, o, d, jax.random.key(12), config=cfg_rr))
    assert np.isfinite(r_fixed).all() and np.isfinite(r_rr).all()
    # Means agree within Monte Carlo noise (a few percent at R=4096).
    np.testing.assert_allclose(r_fixed.mean(), r_rr.mean(), rtol=0.08)
    assert r_fixed.mean() > 0.5  # bright closed box: plenty of energy


def test_throughput_never_amplifies_without_emitters():
    """With all albedos ≤ 1 and no emitter, radiance must be 0."""
    scene = _closed_box_scene(kd=0.9, ka_roof=0.0)
    # make roof diffuse too: Ka=0 → no emitters anywhere
    R = 512
    o = jnp.tile(jnp.asarray([[0.0, 4.0, 0.0]], jnp.float32), (R, 1))
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32), (R, 1))
    cfg = TraceConfig(mode="fixed", max_depth=5, ray_chunk=0)
    rad = np.asarray(trace_radiance(scene, o, d, jax.random.key(0), config=cfg))
    np.testing.assert_allclose(rad, 0.0, atol=1e-7)


def test_render_deterministic_per_key():
    scene, cam = cornell.cornell_box(width=16, height=16)
    cfg = TraceConfig(max_depth=3, ray_chunk=0)
    img1 = render_sample_batch(scene, cam, jax.random.key(5), width=16, height=16, config=cfg)
    img2 = render_sample_batch(scene, cam, jax.random.key(5), width=16, height=16, config=cfg)
    img3 = render_sample_batch(scene, cam, jax.random.key(6), width=16, height=16, config=cfg)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
    assert not np.array_equal(np.asarray(img1), np.asarray(img3))


def test_ray_chunking_matches_unchunked():
    scene, cam = cornell.cornell_box(width=16, height=16)
    cfg_a = TraceConfig(max_depth=3, ray_chunk=0)
    cfg_b = TraceConfig(max_depth=3, ray_chunk=64)
    img_a = render_sample_batch(scene, cam, jax.random.key(5), width=16, height=16, config=cfg_a)
    img_b = render_sample_batch(scene, cam, jax.random.key(5), width=16, height=16, config=cfg_b)
    # chunking changes per-tile keys, so images differ statistically but
    # both must be finite and close in mean
    a, bb = np.asarray(img_a), np.asarray(img_b)
    assert np.isfinite(a).all() and np.isfinite(bb).all()
    np.testing.assert_allclose(a.mean(), bb.mean(), rtol=0.35)


def test_cornell_smoke_render():
    """Low-spp Cornell render: light is the brightest region; left wall
    picks up red bounce, right wall blue."""
    scene, cam = cornell.cornell_box(width=32, height=32)
    cfg = TraceConfig(max_depth=4, ray_chunk=0)
    imgs = []
    for s in range(8):
        imgs.append(
            np.asarray(
                render_sample_batch(scene, cam, jax.random.key(100 + s), width=32, height=32, config=cfg)
            )
        )
    img = np.mean(imgs, axis=0)
    assert np.isfinite(img).all()
    assert img.max() > 1.0  # emitter visible (Ka*ILLUM = 7.8)
    # left third should be redder than blue, right third bluer than red
    left = img[8:28, :8]
    right = img[8:28, -8:]
    assert left[..., 0].mean() > left[..., 2].mean()
    assert right[..., 2].mean() > right[..., 0].mean()
    # some global illumination reached the floor
    assert img[20:, 8:-8].mean() > 0.01


def _one_segment_inputs(R=64, seed=0):
    """A shaded wavefront inside the full Cornell box plus uniforms."""
    from montecarlopathtracer.render.integrator import _make_intersect_shade

    scene, _ = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=8, height=8
    )
    key = jax.random.key(seed)
    k = jax.random.split(key, 6)
    lo, hi = (np.asarray(x) for x in scene.aabb())
    pos = jnp.asarray(
        (lo + (hi - lo) * (0.1 + 0.8 * np.asarray(jax.random.uniform(k[0], (R, 3))))).T,
        jnp.float32,
    )
    d = jax.random.normal(k[1], (3, R))
    d = d / jnp.linalg.norm(d, axis=0, keepdims=True)
    throughput = jax.random.uniform(k[2], (3, R), minval=0.05, maxval=1.0)
    result = jnp.zeros((3, R))
    active = jax.random.uniform(k[3], (R,)) > 0.2
    u = jax.random.uniform(k[4], (3, R))
    cfg = TraceConfig(max_depth=4, rr_depth=2, ray_chunk=0)
    s = _make_intersect_shade(scene, cfg, None)(pos, d)
    return s, pos, d, throughput, result, active, u


@pytest.mark.parametrize(
    "mode,depth",
    [("fixed", 0), ("fixed", 4), ("rr", 0), ("rr", 3), ("rr", 6)],
)
def test_segment_epilogue_lane_flags_match_scalar(mode, depth):
    """Per-lane [R] depth flags (regenerating wavefront) and scalar
    flags (scan integrator) give bit-identical segment updates when
    every lane sits at the same depth."""
    from montecarlopathtracer.render.integrator import (
        segment_epilogue,
        segment_flags,
    )

    s, pos, d, throughput, result, active, u = _one_segment_inputs()
    R = pos.shape[1]
    cfg = TraceConfig(mode=mode, max_depth=4, rr_depth=2, ray_chunk=0)
    u_rr = u[2] if mode == "rr" else None
    scalar = segment_epilogue(
        cfg, s, pos, d, throughput, result, active, u[0], u[1], u_rr,
        *segment_flags(cfg, jnp.int32(depth)),
    )
    lanes = segment_epilogue(
        cfg, s, pos, d, throughput, result, active, u[0], u[1], u_rr,
        *segment_flags(cfg, jnp.full((R,), depth, jnp.int32)),
    )
    for x, y in zip(scalar, lanes):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    still = np.asarray(scalar[4])
    assert not still[~np.asarray(active)].any()  # dead lanes stay dead


@pytest.mark.parametrize(
    "mode,depth,expect",
    [
        ("fixed", 3, (False, False, False)),
        ("fixed", 4, (True, False, False)),
        ("rr", 1, (False, False, False)),
        ("rr", 2, (False, True, False)),
        ("rr", 6, (False, False, True)),
    ],
)
def test_segment_flags(mode, depth, expect):
    from montecarlopathtracer.render.integrator import segment_flags

    cfg = TraceConfig(mode=mode, max_depth=4, rr_depth=2)
    got = segment_flags(cfg, jnp.asarray([depth, depth], jnp.int32))
    for g, e in zip(got, expect):
        assert g.shape == (2,)
        assert bool(g[0]) is e and bool(g[1]) is e


@pytest.mark.parametrize(
    "requested,platform,expect",
    [
        ("auto", "gpu", "nearest"),
        ("auto", "cpu", "brute"),
        ("brute", "gpu", "brute"),
        ("brute", "cpu", "brute"),
        ("kdtree", "gpu", "kdtree"),
        ("nearest", "cpu", "nearest"),
    ],
)
def test_resolve_intersector(requested, platform, expect):
    from montecarlopathtracer.render.integrator import resolve_intersector

    assert resolve_intersector(requested, platform) == expect


def test_resolve_intersector_rejects_other_platforms():
    from montecarlopathtracer.render.integrator import resolve_intersector

    with pytest.raises(RuntimeError):
        resolve_intersector("auto", "rocm")


@pytest.mark.parametrize(
    "requested,intersector,expect",
    [(None, "nearest", 0), (None, "brute", 30000), (4096, "nearest", 4096)],
)
def test_resolve_ray_chunk(requested, intersector, expect):
    from montecarlopathtracer.cli import resolve_ray_chunk

    assert resolve_ray_chunk(requested, intersector) == expect


def test_nearest_intersector_renders_like_brute():
    """The scan integrator on the nearest kernel (interpreted) renders
    the same image as on the lax oracle, and the default "outputs"
    remat (the kernel index saved for the backward) gives the same
    gradient as replaying the kernel."""
    scene, cam = cornell.cornell_box(width=12, height=10)
    key = jax.random.key(4)
    base = dict(max_depth=2, ray_chunk=0)
    img_b = render_sample_batch(
        scene, cam, key, width=12, height=10, config=TraceConfig(**base)
    )
    cfg_n = TraceConfig(intersector="nearest", pallas_interpret=True, **base)
    img_n = render_sample_batch(
        scene, cam, key, width=12, height=10, config=cfg_n
    )
    np.testing.assert_allclose(np.asarray(img_n), np.asarray(img_b),
                               rtol=1e-5, atol=1e-6)

    from montecarlopathtracer.diff.grad import render_image

    def g(cfg):
        def f(s):
            p = {"mat_kd": scene.mat_kd * s}
            return jnp.mean(render_image(p, scene, cam, key, width=12,
                                         height=10, spp=1, config=cfg))
        return float(jax.grad(f)(jnp.float32(1.0)))

    cfg_r = TraceConfig(intersector="nearest", pallas_interpret=True,
                        remat_segments=True, **base)
    assert cfg_n.remat_segments == "outputs"  # the default
    np.testing.assert_allclose(g(cfg_n), g(cfg_r), rtol=1e-6)
