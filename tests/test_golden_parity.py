"""Low-res CPU parity against the reference's committed render.

The full-resolution GPU run lives in tools/golden_run.py (results:
GOLDEN.md, goldens/GOLDEN.json). This is the CI-sized version: render
scene02 at 100×75 / 16 spp with the lax oracle and compare the
structure (5×5-downsampled MAE) against `result2.png` downsampled to
the same grid. Scene2 is the workload whose committed golden matches
the code's nominal ILLUM=10 (scene1's was rendered at luminance ≈30 —
see GOLDEN.md), so no scale fitting is needed here.
"""

import numpy as np
import pytest

from montecarlopathtracer.models import cornell

GOLDEN = "/root/reference/CVMCTracer/CVMCTracer/result2.png"


@pytest.mark.skipif(
    not cornell.has_reference_scenes(), reason="reference scenes not mounted"
)
def test_scene2_structural_parity_vs_committed_golden():
    from montecarlopathtracer.render.film import tonemap_linear
    from montecarlopathtracer.render.integrator import TraceConfig
    from montecarlopathtracer.render.renderer import (
        Renderer,
        RenderSettings,
    )
    from montecarlopathtracer.utils.image import load_png

    golden = load_png(GOLDEN).astype(np.float64) / 255.0  # (600, 800, 3)
    scene, cam = cornell.load_reference_scene(2, width=100, height=75)
    config = TraceConfig(
        mode="fixed", max_depth=7, illum=10.0, ray_chunk=0,
        intersector="brute",
    )
    settings = RenderSettings(
        width=100, height=75, spp_per_pass=4, passes=4, seed=0
    )
    r = Renderer(scene, cam, config, settings)
    r.render()
    ours = tonemap_linear(np.asarray(r.film.color)).astype(np.float64) / 255.0

    g_lo = golden.reshape(75, 8, 100, 8, 3).mean(axis=(1, 3))  # → 75×100
    # structural compare on a 15×20 grid (averages out the 16-spp noise)
    down5 = lambda x: x.reshape(15, 5, 20, 5, 3).mean(axis=(1, 3))  # noqa: E731
    mae = float(np.abs(down5(ours) - down5(g_lo)).mean())
    assert mae < 0.03, mae
    # and the global brightness must match at nominal illum=10
    shift = float(np.abs(ours.mean() - g_lo.mean()))
    assert shift < 0.02, shift
