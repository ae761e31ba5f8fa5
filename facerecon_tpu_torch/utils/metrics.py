"""Acceptance metrics (a copy of facerecon_tpu/utils/metrics.py) —
SURVEY.md §2 K7 / BASELINE.md.

PSNR of rendered images and vertex MAE vs the CPU oracle ARE the acceptance
metrics (BASELINE.json:2), so they live here as library functions.
"""

from __future__ import annotations

import numpy as np


def psnr(a, b, peak: float = 1.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def vertex_mae(a, b) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


def landmark_rmse(pred, gt) -> float:
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    return float(np.sqrt(np.mean(np.sum((pred - gt) ** 2, axis=-1))))
