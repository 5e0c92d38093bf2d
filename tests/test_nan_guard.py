"""NaN-poisoning guard pass (SURVEY.md §5: enable jax.debug_nans in
tests). The masked-`where` sampler guards (ops/sampling.py) are exactly
where a regression would produce silent NaNs that otherwise surface only
as statistical flakes; with ``jax_debug_nans`` any NaN produced by a
primitive raises immediately.

Note on coverage: debug_nans checks primitive *outputs*, so a NaN that
is produced and then masked away by a later `where` still trips it —
the guards under test must keep NaNs from ever being materialized.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlopathtracer.models import cornell
from montecarlopathtracer.render.integrator import (
    TraceConfig,
    render_sample_batch,
)


@pytest.fixture
def debug_nans():
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("mode", ["fixed", "rr"])
def test_render_produces_no_nans_under_debug_nans(debug_nans, mode):
    scene, cam = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=16, height=16
    )
    cfg = TraceConfig(mode=mode, max_depth=4, rr_depth=2, ray_chunk=0)
    img = jax.jit(
        render_sample_batch, static_argnames=("width", "height", "config")
    )(scene, cam, jax.random.key(1), width=16, height=16, config=cfg)
    assert np.isfinite(np.asarray(img)).all()


def test_gradients_produce_no_nans_under_debug_nans(debug_nans):
    from montecarlopathtracer.diff.grad import (
        split_params,
        make_loss_fn,
    )

    scene, cam = cornell.cornell_box(width=8, height=8)
    cfg = TraceConfig(mode="fixed", max_depth=2, ray_chunk=0)
    target = jnp.zeros((8, 8, 3))
    loss_fn = make_loss_fn(
        scene, cam, target, width=8, height=8, spp=1, config=cfg
    )
    params = split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jax.random.key(2)
    )
    assert np.isfinite(float(loss))
    for k, g in grads.items():
        assert np.isfinite(np.asarray(g)).all(), k


def test_vertex_grads_finite_through_megakernel_fresnel():
    """Regression: sqrt(max(x, 0)) at the TIR/grazing boundary used
    to produce 0·∞ = NaN in sample_fresnel's backward, poisoning
    vertex gradients through the kernel path on any specular scene.
    Interior vertex gradients must be exactly zero (the material model
    cancels every geometric factor — diff/grad.py), never NaN."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from montecarlopathtracer.models import cornell
    from montecarlopathtracer.render.integrator import TraceConfig
    from montecarlopathtracer.diff.grad import make_loss_fn, split_params

    scene, cam = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=16, height=16
    )
    params = split_params(scene, ("vertices",))
    cfg = TraceConfig(
        mode="fixed", max_depth=3, ray_chunk=0, intersector="nearest",
        pallas_interpret=True, remat_segments=False,
    )
    loss_fn = make_loss_fn(
        scene, cam, jnp.zeros((16, 16, 3)), width=16, height=16, spp=1,
        config=cfg,
    )
    loss, g = jax.value_and_grad(loss_fn)(params, jax.random.key(3))
    gv = np.asarray(g["vertices"])
    assert np.isfinite(gv).all()
    assert np.abs(gv).max() == 0.0  # interior vertex gradient is zero
