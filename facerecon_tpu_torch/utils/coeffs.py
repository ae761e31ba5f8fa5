"""Coefficient codec (twin of facerecon_tpu/utils/coeffs.py).

Splits/concats the regressed coefficient vector
  [alpha id | beta exp | delta tex | angles(3) | gamma(27) | trans(3)]
into a typed NamedTuple. Works on batched (B, n_coeff) or unbatched
(n_coeff,) tensors; the parts are views of the input. A FLAME config
(cfg.model == "flame") splits DECA's 236 codes
  [shape 100 | tex 50 | exp 50 | pose 6 | cam 3 | light 27]
(DECA's param_list order) into `DECACodes` instead; a detail config
(cfg.n_detail > 0) has the detail code last, [... | detail n_detail],
and the coarse config's `detail` is None. A GaussianAvatars config
(cfg.model == "gavatar") splits a frame's
  [shape 300 | exp 100 | pose 15 | trans 3 | view 12 | focal 2]
into `AvatarCodes`: FLAME's parameters, then the frame's pinhole camera.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from facerecon_tpu_torch.config import FaceReconConfig, is_flame, is_gavatar


class Coeffs(NamedTuple):
    id: torch.Tensor      # (..., K_id)
    exp: torch.Tensor     # (..., K_exp)
    tex: torch.Tensor     # (..., K_tex)
    angles: torch.Tensor  # (..., 3) Euler radians
    gamma: torch.Tensor   # (..., 27) SH illumination, 9 per RGB channel
    trans: torch.Tensor   # (..., 3) translation


class DECACodes(NamedTuple):
    shape: torch.Tensor   # (..., 100) FLAME identity
    tex: torch.Tensor     # (..., 50) albedo PCA
    exp: torch.Tensor     # (..., 50) FLAME expression
    pose: torch.Tensor    # (..., 6) global rotation | jaw, axis-angle
    cam: torch.Tensor     # (..., 3) orthographic scale s, tx, ty
    light: torch.Tensor   # (..., 27) SH-9 x RGB, coefficient-major (9, 3)
    detail: torch.Tensor | None = None  # (..., n_detail) detail code


class AvatarCodes(NamedTuple):
    shape: torch.Tensor   # (..., 300) FLAME identity
    exp: torch.Tensor     # (..., 100) FLAME expression
    pose: torch.Tensor    # (..., 15) global | neck | jaw | eyes, axis-angle
    trans: torch.Tensor   # (..., 3) FLAME's translation (m)
    view: torch.Tensor    # (..., 12) world-to-camera [R | t], row-major
                          # 3 x 4 (x right, y down, z forward)
    focal: torch.Tensor   # (..., 2) fx, fy in pixels; the principal point
                          # is the image's centre


def split_coeff(coeff: torch.Tensor, cfg: FaceReconConfig):
    """Coeffs for a BFM config, DECACodes for a FLAME one, AvatarCodes for
    a GaussianAvatars one."""
    if is_gavatar(cfg):
        return AvatarCodes(*torch.split(coeff, list(cfg.coeff_sizes),
                                        dim=-1))
    if is_flame(cfg):
        return DECACodes(*torch.split(coeff, list(cfg.coeff_sizes), dim=-1))
    bounds = (0, *cfg.coeff_split, cfg.n_coeff)
    sizes = [hi - lo for lo, hi in zip(bounds[:-1], bounds[1:])]
    return Coeffs(*torch.split(coeff, sizes, dim=-1))


def join_coeff(c) -> torch.Tensor:
    return torch.cat([t for t in c if t is not None], dim=-1)
