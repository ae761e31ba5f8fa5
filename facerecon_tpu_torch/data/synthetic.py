"""Synthetic coefficient draws (twin of facerecon_tpu/data/synthetic.py).

Only `sample_coeffs` is ported in this slice: plausible random
coefficient vectors, drawn with numpy so that both packages can be fed
the same draws.
"""

from __future__ import annotations

import numpy as np

from facerecon_tpu_torch.config import FaceReconConfig


def sample_coeffs(rng: np.random.Generator, cfg: FaceReconConfig,
                  batch: int, scale: float = 0.3) -> np.ndarray:
    c = (rng.standard_normal((batch, cfg.n_coeff)) * scale).astype(np.float32)
    s = cfg.coeff_split
    c[:, s[2]:s[3]] *= 0.3   # mild pose
    c[:, s[4]:] *= 0.1       # small translation
    # gamma: near channel-balanced lighting (shared SH vector + small
    # per-channel jitter) keeps radiance in a realistic range
    shared = rng.standard_normal((batch, 1, 9)) * 0.15
    jitter = rng.standard_normal((batch, 3, 9)) * 0.02
    c[:, s[3]:s[4]] = (shared + jitter).reshape(batch, 27).astype(np.float32)
    return c
