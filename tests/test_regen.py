"""Regenerating-wavefront renderer (render/regen.py) correctness.

Two layers, CPU/interpret:

- spp=1: no lane ever regenerates, so every live lane sits at the same
  depth and the stream indexing coincides with the scan integrator's —
  the result must be BIT-IDENTICAL to `render_rows_planar` on every
  intersector (this exercises the per-lane depth flags of the shared
  segment epilogue end to end: equal-depth lane flags must reproduce
  the scalar-flags arithmetic exactly).
- spp>1: different (still iid) stream association — check the
  estimator statistically: global means agree within MC noise, and the
  regen image is unbiased against a converged scan reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlopathtracer.models import cornell
from montecarlopathtracer.render.integrator import (
    TraceConfig,
    render_rows_planar,
)
from montecarlopathtracer.render.regen import render_regen_planar


def _scene(w, h):
    return cornell.cornell_box(width=w, height=h)


@pytest.mark.parametrize(
    "kw",
    [
        dict(mode="fixed", max_depth=3, intersector="nearest"),
        dict(mode="rr", rr_depth=2, illum=1.0, intersector="nearest"),
        dict(mode="fixed", max_depth=2, intersector="brute"),
        dict(mode="rr", rr_depth=2, illum=1.0, intersector="brute"),
    ],
)
def test_regen_spp1_bit_identical(kw):
    W, H = 32, 24
    scene, camera = _scene(W, H)
    cfg = TraceConfig(pallas_interpret=True, ray_chunk=0, **kw)
    key = jax.random.key(7)
    a = render_rows_planar(scene, camera, key, W, H, 0, H, cfg)
    b = render_regen_planar(scene, camera, key, W, H, 1, cfg)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_regen_multi_spp_statistics():
    W, H = 24, 18
    scene, camera = _scene(W, H)
    cfg = TraceConfig(
        mode="rr", rr_depth=2, illum=1.0, intersector="nearest",
        pallas_interpret=True, ray_chunk=0,
    )
    key = jax.random.key(11)
    n = 8
    acc = jnp.zeros((3, H, W))
    for i in range(n):
        acc = acc + render_rows_planar(
            scene, camera, jax.random.fold_in(key, i), W, H, 0, H, cfg
        )
    a = np.asarray(acc / n)
    b = np.asarray(render_regen_planar(scene, camera, key, W, H, n, cfg))
    # Same estimator, different iid streams: global means agree within
    # MC noise of ~5k samples (loose bound; catches quota/accumulation
    # bugs, double counts, dropped tails).
    assert abs(a.mean() - b.mean()) < 0.35 * a.mean() + 1e-4, (
        a.mean(), b.mean(),
    )
    assert np.isfinite(b).all()
    assert (b >= 0).all()
