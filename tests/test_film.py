"""Film accumulation, tonemapping, and renderer checkpoint/resume."""

import os

import numpy as np
import jax
import jax.numpy as jnp

from montecarlopathtracer.render.film import (
    Film,
    film_update,
    film_update_gamma,
    tonemap_linear,
    tonemap_gamma,
)
from montecarlopathtracer.render.renderer import Renderer, RenderSettings
from montecarlopathtracer.render.integrator import TraceConfig
from montecarlopathtracer.models import cornell


def test_running_mean_matches_overall_mean():
    """The progressive recurrence (CUTracer.cu:215-217) must equal the
    plain mean of all batches."""
    rng = np.random.default_rng(0)
    batches = [rng.uniform(size=(4, 4, 3)).astype(np.float32) for _ in range(7)]
    film = Film.zeros(4, 4)
    for b in batches:
        film = film_update(film, jnp.asarray(b), 1.0)
    np.testing.assert_allclose(
        np.asarray(film.color), np.mean(batches, axis=0), rtol=1e-5
    )
    assert float(film.weight) == 7.0


def test_weighted_batches():
    film = Film.zeros(1, 1)
    film = film_update(film, jnp.full((1, 1, 3), 1.0), 3.0)
    film = film_update(film, jnp.full((1, 1, 3), 5.0), 1.0)
    np.testing.assert_allclose(np.asarray(film.color), 2.0, rtol=1e-6)


def test_gamma_accumulation_matches_reference_recurrence():
    """MCRT's gamma-space running mean (rtx.hlsl:400-404): encoded film
    c_k satisfies c_k^2.2 = mean of linear batches."""
    rng = np.random.default_rng(1)
    batches = [rng.uniform(size=(2, 2, 3)).astype(np.float32) for _ in range(5)]
    film = Film.zeros(2, 2)
    for b in batches:
        film = film_update_gamma(film, jnp.asarray(b), 1.0)
    decoded = np.power(np.asarray(film.color), 2.2)
    np.testing.assert_allclose(decoded, np.mean(batches, axis=0), rtol=1e-4)


def test_variance_estimate_tracks_batch_spread():
    """Welford m2: identical batches → zero variance; spread batches →
    positive, roughly var/n of the batch means."""
    film = Film.zeros(1, 1)
    for _ in range(5):
        film = film_update(film, jnp.full((1, 1, 3), 2.0), 1.0)
    assert float(film.variance_of_mean()) < 1e-12

    rng = np.random.default_rng(2)
    vals = rng.normal(1.0, 0.5, size=100).astype(np.float32)
    film = Film.zeros(1, 1)
    for v in vals:
        film = film_update(film, jnp.full((1, 1, 3), float(v)), 1.0)
    est = float(film.variance_of_mean())
    expected = float(np.var(vals, ddof=1) / len(vals))
    assert 0.5 * expected < est < 2.0 * expected, (est, expected)


def test_tonemaps():
    img = jnp.asarray([[[0.5, 2.0, 0.0]]])
    lin = tonemap_linear(img)
    assert lin.dtype == np.uint8
    np.testing.assert_array_equal(lin[0, 0], [127, 255, 0])
    gam = tonemap_gamma(img)
    assert gam[0, 0, 0] == int(np.clip(0.5 ** (1 / 2.2) * 255, 0, 255))


def test_renderer_checkpoint_resume(tmp_path):
    scene, cam = cornell.cornell_box(width=8, height=8)
    cfg = TraceConfig(max_depth=2, ray_chunk=0)
    ckpt = os.path.join(tmp_path, "film.npz")

    s = RenderSettings(
        width=8, height=8, spp_per_pass=2, passes=4, seed=9, checkpoint_path=ckpt
    )
    r1 = Renderer(scene, cam, cfg, s)
    r1.render(2)
    r1.save_checkpoint(ckpt)

    # resume in a fresh renderer and continue 2 more passes
    r2 = Renderer(scene, cam, cfg, s)
    assert r2.pass_idx == 2
    r2.render(2)

    # compare against a straight 4-pass run
    r3 = Renderer(
        scene,
        cam,
        cfg,
        RenderSettings(width=8, height=8, spp_per_pass=2, passes=4, seed=9),
    )
    r3.render(4)
    np.testing.assert_allclose(
        np.asarray(r2.film.color), np.asarray(r3.film.color), rtol=1e-5, atol=1e-7
    )
    assert float(r2.film.weight) == float(r3.film.weight) == 8.0


def test_renderer_step_dumps(tmp_path):
    scene, cam = cornell.cornell_box(width=8, height=8)
    cfg = TraceConfig(max_depth=2, ray_chunk=0)
    step_dir = os.path.join(tmp_path, "steps")
    r = Renderer(
        scene,
        cam,
        cfg,
        RenderSettings(width=8, height=8, spp_per_pass=1, passes=2, step_dir=step_dir),
    )
    r.render()
    assert sorted(os.listdir(step_dir)) == ["step000000.png", "step000001.png"]
