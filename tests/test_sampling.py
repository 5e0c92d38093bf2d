"""BSDF sampler tests: distribution moments and closed-form branches
(reference math: CUDA/Utils.hpp:46-137). Samplers use the SoA [3, R]
vector layout."""

import numpy as np
import jax
import jax.numpy as jnp

from montecarlopathtracer.ops.sampling import (
    sample_hemi,
    sample_phong,
    sample_fresnel,
)

N = 20000


def _uniforms(seed, n=N):
    k = jax.random.key(seed)
    u1 = jax.random.uniform(k, (n,))
    u2 = jax.random.uniform(jax.random.fold_in(k, 1), (n,))
    return u1, u2


def _tile3(v, n=N):
    return jnp.tile(jnp.asarray(v, jnp.float32)[:, None], (1, n))


def test_hemi_cosine_weighted_about_plus_y():
    u1, u2 = _uniforms(0)
    n = _tile3([0.0, 1.0, 0.0])
    d = np.asarray(sample_hemi(u1, u2, n))  # (3, N)
    np.testing.assert_allclose(np.linalg.norm(d, axis=0), 1.0, atol=1e-5)
    assert (d[1] >= 0).all()
    # cosine-weighted: E[cosθ] = 2/3
    np.testing.assert_allclose(d[1].mean(), 2.0 / 3.0, atol=0.01)
    # azimuthal symmetry
    assert abs(d[0].mean()) < 0.02 and abs(d[2].mean()) < 0.02


def test_hemi_neg_y_special_case():
    u1, u2 = _uniforms(1)
    n = _tile3([0.0, -1.0, 0.0])
    d = np.asarray(sample_hemi(u1, u2, n))
    assert (d[1] <= 0).all()
    np.testing.assert_allclose(-d[1].mean(), 2.0 / 3.0, atol=0.01)


def test_hemi_arbitrary_normal_hemisphere():
    u1, u2 = _uniforms(2)
    nv = np.array([1.0, 2.0, -0.5])
    nv /= np.linalg.norm(nv)
    n = _tile3(nv)
    d = np.asarray(sample_hemi(u1, u2, n))
    cos = nv @ d
    assert (cos >= -1e-4).all()
    np.testing.assert_allclose(cos.mean(), 2.0 / 3.0, atol=0.01)
    np.testing.assert_allclose(np.linalg.norm(d, axis=0), 1.0, atol=1e-4)


def test_phong_high_ns_approaches_mirror():
    u1, u2 = _uniforms(3)
    nv = _tile3([0.0, 1.0, 0.0])
    indir = _tile3([np.sqrt(0.5), -np.sqrt(0.5), 0.0])
    ns = jnp.full((N,), 1e5, jnp.float32)
    d = np.asarray(sample_phong(u1, u2, nv, indir, ns))
    mirror = np.array([np.sqrt(0.5), np.sqrt(0.5), 0.0])
    cos = mirror @ d
    assert cos.mean() > 0.999


def test_fresnel_tr_zero_always_reflects():
    u1, _ = _uniforms(4)
    nv = _tile3([0.0, 1.0, 0.0])
    indir = _tile3([np.sqrt(0.5), -np.sqrt(0.5), 0.0])
    tr = jnp.zeros((N,))
    ni = jnp.full((N,), 1.5)
    d = np.asarray(sample_fresnel(u1, nv, indir, tr, ni))
    mirror = np.array([np.sqrt(0.5), np.sqrt(0.5), 0.0])
    np.testing.assert_allclose(d, np.tile(mirror[:, None], (1, N)), atol=1e-5)


def test_fresnel_normal_incidence_refracts_straight():
    # At normal incidence with Tr=1, the Schlick factor is 1 → always
    # refract, and the refracted ray continues straight (Utils.hpp:107-112).
    u1 = jnp.zeros((4,)) + 0.5
    nv = _tile3([0.0, 1.0, 0.0], 4)
    indir = _tile3([0.0, -1.0, 0.0], 4)
    d = np.asarray(
        sample_fresnel(u1, nv, indir, jnp.ones((4,)), jnp.full((4,), 1.5))
    )
    np.testing.assert_allclose(d, np.tile([[0.0], [-1.0], [0.0]], (1, 4)), atol=1e-5)


def test_fresnel_total_internal_reflection():
    # Exiting glass at a grazing angle beyond the critical angle must
    # mirror-reflect (Utils.hpp:116-121). ndoti = cos to normal ≈ 0.2,
    # Ni = 1.5 → test = 1 - (1-0.04)*2.25 < 0 → TIR.
    ct = 0.2
    st = np.sqrt(1 - ct * ct)
    u1 = jnp.zeros((4,))  # u < Tr_eff → take the refract branch
    nv = _tile3([0.0, 1.0, 0.0], 4)
    indir = _tile3([st, ct, 0.0], 4)
    d = np.asarray(
        sample_fresnel(u1, nv, indir, jnp.ones((4,)), jnp.full((4,), 1.5))
    )
    expected = np.array([[st], [-ct], [0.0]])
    np.testing.assert_allclose(d, np.tile(expected, (1, 4)), atol=1e-5)


def test_samplers_finite_at_edge_uniforms():
    # u = 0 and u ≈ 1 must not produce NaN/Inf anywhere.
    for u in (0.0, 1.0 - 1e-7):
        uu = jnp.full((8,), u, jnp.float32)
        nv = _tile3([0.0, 1.0, 0.0], 8)
        indir = _tile3([0.6, -0.8, 0.0], 8)
        assert np.isfinite(np.asarray(sample_hemi(uu, uu, nv))).all()
        assert np.isfinite(
            np.asarray(sample_phong(uu, uu, nv, indir, jnp.full((8,), 10.0)))
        ).all()
        assert np.isfinite(
            np.asarray(
                sample_fresnel(uu, nv, indir, jnp.full((8,), 0.9), jnp.full((8,), 1.5))
            )
        ).all()


def test_sample_phong_reflect_lobe():
    """Classic-Phong sampler: outgoing directions concentrate around
    the mirror reflection with cos^Ns statistics (E[cos α] =
    (Ns+1)/(Ns+2)), and huge Ns collapses to the mirror direction."""
    from montecarlopathtracer.ops.sampling import (
        sample_phong_reflect,
        dot3,
    )

    R = 20000
    key = jax.random.key(0)
    u1 = jax.random.uniform(key, (R,))
    u2 = jax.random.uniform(jax.random.fold_in(key, 1), (R,))
    normal = jnp.tile(jnp.asarray([[0.0], [1.0], [0.0]]), (1, R))
    indir = jnp.tile(
        jnp.asarray([[0.6], [-0.8], [0.0]]), (1, R)
    )  # unit, hitting from above
    mirror = jnp.tile(jnp.asarray([[0.6], [0.8], [0.0]]), (1, R))

    for ns in (5.0, 50.0):
        out = sample_phong_reflect(u1, u2, normal, indir, jnp.full((R,), ns))
        # unit outputs
        np.testing.assert_allclose(
            np.asarray(dot3(out, out)), 1.0, atol=1e-5
        )
        cos_a = np.asarray(dot3(out, mirror))
        expect = (ns + 1.0) / (ns + 2.0)
        assert abs(cos_a.mean() - expect) < 0.01, (ns, cos_a.mean())

    out = sample_phong_reflect(
        u1, u2, normal, indir, jnp.full((R,), 1e6)
    )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(mirror), atol=1e-2
    )
