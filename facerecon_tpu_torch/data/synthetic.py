"""Synthetic data source (twin of facerecon_tpu/data/synthetic.py).

Renders ground-truth coefficient draws into (image, 68-landmark) training
pairs whose true coefficients are known. Coefficients are drawn with
numpy, so both packages can be fed the same draws. The renders run on
the device of the asset tensors and stay there: there is no host wire.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from facerecon_tpu_torch.config import FaceReconConfig
from facerecon_tpu_torch.ops.geometry import DeviceBFM
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.utils.coeffs import split_coeff


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


@torch.no_grad()
def render_batch(coeff: np.ndarray, bfm: DeviceBFM, cfg: FaceReconConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render coefficients -> (images (B,S,S,3), landmarks (B,68,2)) on
    the device of `bfm`.

    The render is the forward-only path (render_coeffs with
    inference=True, kernel K1): it gives the training render's image
    values without building a graph. Images are NOT clipped: a clipped
    target would put an irreducible floor under the photometric loss of
    any closed-loop recovery experiment. Clip only when saving for
    display."""
    c = split_coeff(torch.as_tensor(coeff, device=bfm.faces.device), cfg)
    out = render_coeffs(c, bfm, cfg, inference=True)
    return out.image, out.geometry.landmarks2d


def synthetic_batches(bfm: DeviceBFM, cfg: FaceReconConfig, batch: int,
                      seed: int = 0, scale: float = 0.3, pool: int = 0,
                      shard: Optional[Callable] = None,
                      ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                          np.ndarray]]:
    """Endless (images, landmarks68, true_coeffs) batches.

    pool > 0 renders that many batches once and cycles them (shuffled
    per epoch): an endless fresh stream renders ground truth on the
    training device every step, serialized with the train step.

    shard: maps each global draw of `batch` coefficients to the part
    this process renders (parallel/mesh.shard_batch). Every rank draws
    the same global batches from `seed` and renders only its slice, so
    the slices of all ranks make up the one-process batch."""
    rng = np.random.default_rng(seed)
    keep = shard or (lambda c: c)
    if pool <= 0:
        while True:
            coeff = keep(sample_coeffs(rng, cfg, batch, scale))
            img, lmk = render_batch(coeff, bfm, cfg)
            yield img, lmk, coeff
    cached = []
    for _ in range(pool):
        coeff = keep(sample_coeffs(rng, cfg, batch, scale))
        img, lmk = render_batch(coeff, bfm, cfg)
        cached.append((img, lmk, coeff))
    while True:
        for i in rng.permutation(pool):
            yield cached[int(i)]
