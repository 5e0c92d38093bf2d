"""Golden-image comparison — the framework's regression machinery for
the reference's committed renders (`result1..4.png`, `result1step/`,
`result2step/`, MCRT `result.png`), which are its de-facto baselines
(SURVEY.md §4: the reference has no tests, only these images).

Metrics are computed on 8-bit RGB in [0, 1]:

- ``mae`` — mean absolute error;
- ``rmse`` / ``psnr`` — root-mean-square error and PSNR in dB;
- ``mean_shift`` — |mean(a) − mean(b)| per channel, separating exposure
  differences (emitter-scale / spp mismatches) from structure;
- ``downsampled mae`` — MAE after 8×8 box-downsampling, which washes
  out Monte-Carlo noise and compares illumination structure (two
  unconverged renders of the same scene agree here long before they
  agree per-pixel).

CLI:
    python -m montecarlopathtracer.utils.golden ours.png theirs.png
"""

from __future__ import annotations

import json
import sys
from typing import Dict

import numpy as np

from .image import load_png


def _downsample(x: np.ndarray, f: int) -> np.ndarray:
    h, w, c = x.shape
    h2, w2 = h // f * f, w // f * f
    x = x[:h2, :w2]
    return x.reshape(h2 // f, f, w2 // f, f, c).mean(axis=(1, 3))


def compare_images(a: np.ndarray, b: np.ndarray, down: int = 8) -> Dict:
    """Compare two H×W×3 uint8 (or float [0,1]) images; dict of metrics."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    fa = a.astype(np.float64)
    fb = b.astype(np.float64)
    if fa.max() > 1.5:  # 8-bit input
        fa /= 255.0
    if fb.max() > 1.5:
        fb /= 255.0
    err = fa - fb
    mae = float(np.abs(err).mean())
    rmse = float(np.sqrt((err**2).mean()))
    psnr = float(20.0 * np.log10(1.0 / max(rmse, 1e-12)))
    mean_shift = np.abs(fa.mean(axis=(0, 1)) - fb.mean(axis=(0, 1)))
    da, db = _downsample(fa, down), _downsample(fb, down)
    return {
        "mae": round(mae, 6),
        "rmse": round(rmse, 6),
        "psnr_db": round(psnr, 2),
        "mean_shift": [round(float(x), 6) for x in mean_shift],
        f"mae_down{down}": round(float(np.abs(da - db).mean()), 6),
    }


def compare_files(path_a: str, path_b: str, down: int = 8) -> Dict:
    return compare_images(load_png(path_a), load_png(path_b), down=down)


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 2:
        print(
            "usage: python -m montecarlopathtracer.utils.golden A.png B.png",
            file=sys.stderr,
        )
        return 2
    print(json.dumps(compare_files(args[0], args[1])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
