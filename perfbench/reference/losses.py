"""The self-supervised losses, plain float32 (Deng et al.,
arXiv:1903.08527, as the configuration weights them):

  photo    per image, sum over pixels of mask * ||render - target||_2
           over the sum of the mask (at least 1), mask = coverage times
           the interpolated skin weight; batch mean
  landmark (1/68) sum_k w_k ||q_k - q^_k||^2 / size^2, w_k 20 on the
           nose (27-35) and inner mouth (60-67), else 1; batch mean
  reg      w_scale (w_id |id/sigma_id|^2 + w_exp |exp/sigma_exp|^2
           + w_tex |tex/sigma_tex|^2), batch mean
  gamma    sum over the 27 SH values of the squared deviation from the
           mean over the three channels; batch mean
  total    w_photo photo + reg + w_gamma gamma + w_landmark landmark
"""

from __future__ import annotations

import torch

INNER = tuple(range(27, 36)) + tuple(range(60, 68))


def photometric(image, target, mask):
    diff = torch.sqrt(((image - target) ** 2).sum(-1) + 1e-12)
    per = (diff * mask).sum((1, 2)) / torch.clamp(mask.sum((1, 2)), min=1.0)
    return per.mean()


def landmark(pred, gt, size: int, inner_weight: float):
    w = torch.ones(pred.shape[1], device=pred.device)
    w[list(INNER)] = inner_weight
    sq = ((pred - gt) ** 2).sum(-1)
    return ((w * sq).mean(-1) / size ** 2).mean()


def regularization(cid, cexp, ctex, mesh, lw: dict):
    def term(x, s):
        return ((x / s) ** 2).sum(-1).mean()
    return lw["w_reg_scale"] * (lw["w_reg_id"] * term(cid, mesh.sigma_id)
                                + lw["w_reg_exp"] * term(cexp,
                                                         mesh.sigma_exp)
                                + lw["w_reg_tex"] * term(ctex,
                                                         mesh.sigma_tex))


def gamma_balance(gamma):
    g = gamma.reshape(-1, 3, 9)
    return ((g - g.mean(1, keepdim=True)) ** 2).sum((1, 2)).mean()


def total(parts: dict, lw: dict):
    return (lw["w_photo"] * parts["photo"] + parts["reg"]
            + lw["w_gamma"] * parts["gamma"]
            + lw["w_landmark"] * parts["landmark"])
