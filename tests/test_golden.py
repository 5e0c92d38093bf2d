"""Golden-image comparison metrics."""

import numpy as np
import pytest

from montecarlopathtracer.utils.golden import compare_images


def test_identical_images():
    rng = np.random.default_rng(0)
    img = (rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)
    m = compare_images(img, img)
    assert m["mae"] == 0.0
    assert m["psnr_db"] > 100.0


def test_noise_vs_structure_separation():
    """Two noisy renders of the same signal: per-pixel MAE large,
    downsampled MAE small; a brightness shift shows up in mean_shift."""
    rng = np.random.default_rng(1)
    base = rng.uniform(0.2, 0.8, size=(64, 64, 3))
    a = np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1)
    b = np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1)
    m = compare_images(a, b)
    assert m["mae"] > 3 * m["mae_down8"]

    shifted = np.clip(base + 0.2, 0, 1)
    m2 = compare_images(base, shifted)
    assert min(m2["mean_shift"]) > 0.15


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        compare_images(np.zeros((4, 4, 3)), np.zeros((8, 8, 3)))
