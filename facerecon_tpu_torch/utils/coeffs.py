"""Coefficient codec (twin of facerecon_tpu/utils/coeffs.py).

Splits/concats the regressed coefficient vector
  [alpha id | beta exp | delta tex | angles(3) | gamma(27) | trans(3)]
into a typed NamedTuple. Works on batched (B, n_coeff) or unbatched
(n_coeff,) tensors; the parts are views of the input.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from facerecon_tpu_torch.config import FaceReconConfig


class Coeffs(NamedTuple):
    id: torch.Tensor      # (..., K_id)
    exp: torch.Tensor     # (..., K_exp)
    tex: torch.Tensor     # (..., K_tex)
    angles: torch.Tensor  # (..., 3) Euler radians
    gamma: torch.Tensor   # (..., 27) SH illumination, 9 per RGB channel
    trans: torch.Tensor   # (..., 3) translation


def split_coeff(coeff: torch.Tensor, cfg: FaceReconConfig) -> Coeffs:
    bounds = (0, *cfg.coeff_split, cfg.n_coeff)
    sizes = [hi - lo for lo, hi in zip(bounds[:-1], bounds[1:])]
    return Coeffs(*torch.split(coeff, sizes, dim=-1))


def join_coeff(c: Coeffs) -> torch.Tensor:
    return torch.cat(list(c), dim=-1)
