"""Self-supervised losses (twin of facerecon_tpu/ops/losses.py).

  photometric: skin-masked robust per-pixel L2,1 over the rendered region
  landmark:    weighted MSE of 68 projected vs detected points, size-normalized
  regularize:  Tikhonov on id/exp/tex coeffs weighted by 1/sigma (PCA
               eigenvalue sqrt) + gamma channel-balance term

Same terms, weights and reductions as the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from facerecon_tpu_torch.config import FaceReconConfig
from facerecon_tpu_torch.ops.geometry import DeviceBFM
from facerecon_tpu_torch.ops.render import RenderOut
from facerecon_tpu_torch.utils.coeffs import Coeffs

_INNER = (27, 28, 29, 30, 31, 32, 33, 34, 35,    # nose
          60, 61, 62, 63, 64, 65, 66, 67)         # inner mouth


def photometric_loss(rendered, target, mask):
    """L_photo = sum_p m_p ||I_p - Ihat_p||_2 / sum_p m_p  (per batch mean).

    rendered/target (B,H,W,3); mask (B,H,W) = rendered coverage (already
    intersected with the skin mask by the caller)."""
    diff = torch.sqrt(torch.sum((rendered - target) ** 2, dim=-1) + 1e-12)
    per_image = (torch.sum(diff * mask, dim=(1, 2))
                 / torch.clamp(torch.sum(mask, dim=(1, 2)), min=1.0))
    return torch.mean(per_image)


def skin_mask_image(out: RenderOut, bfm: DeviceBFM):
    """Rasterize the per-vertex skin mask into image space, AND with
    coverage: one per-pixel row gather from the static (F, 3) skin-corner
    table, blended by the barycentrics (the gradient flows through them
    only)."""
    sk = bfm.skin_mask[bfm.faces.reshape(-1)].reshape(-1, 3)  # (F,3) static
    b, h, w = out.tri_id.shape
    safe = torch.clamp(out.tri_id, min=0).reshape(b, -1).to(torch.int64)
    px = sk[safe]                                             # (B,HW,3)
    img = torch.sum(px * out.bary.reshape(b, -1, 3), dim=-1)
    return out.mask * img.reshape(b, h, w)


def landmark_weights(cfg: FaceReconConfig, device=None):
    """Up-weight nose + inner mouth (indices per the 68-pt convention)."""
    w = torch.ones((cfg.n_landmarks,), dtype=torch.float32, device=device)
    w[list(_INNER)] = cfg.landmark_weight_inner
    return w


def landmark_loss(pred, gt, cfg: FaceReconConfig):
    """(1/68) sum_k w_k ||q_k - qhat_k||^2 / image_size^2, batch mean."""
    w = landmark_weights(cfg, pred.device)
    sq = torch.sum((pred - gt) ** 2, dim=-1)                  # (B,68)
    per_image = torch.mean(w[None, :] * sq, dim=-1) / (cfg.image_size ** 2)
    return torch.mean(per_image)


def regularization_loss(c: Coeffs, bfm: DeviceBFM, cfg: FaceReconConfig):
    """Tikhonov on alpha/beta/delta weighted by inverse PCA sigmas."""
    def term(x, sigma):
        return torch.mean(torch.sum((x / sigma) ** 2, dim=-1))

    reg = (cfg.w_reg_id * term(c.id, bfm.sigma_id)
           + cfg.w_reg_exp * term(c.exp, bfm.sigma_exp)
           + cfg.w_reg_tex * term(c.tex, bfm.sigma_tex))
    return cfg.w_reg_scale * reg


def texture_variance_loss(texture, bfm: DeviceBFM):
    """Optional flat-albedo prior: per-channel variance of the predicted
    albedo (B,N,3) over the SKIN region, pushing shading variation into
    the SH illumination instead of baked-in texture."""
    w = bfm.skin_mask[None, :, None]                          # (1,N,1)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(texture * w, dim=1, keepdim=True) / wsum
    var = torch.sum(w * (texture - mean) ** 2, dim=1) / wsum  # (B,3)
    return torch.mean(torch.sum(var, dim=-1))


def gamma_loss(gamma):
    """Channel-balance: penalize per-channel deviation from the
    cross-channel mean of each SH coefficient."""
    g = gamma.reshape(*gamma.shape[:-1], 3, 9)
    mean = torch.mean(g, dim=-2, keepdim=True)
    return torch.mean(torch.sum((g - mean) ** 2, dim=(-1, -2)))


def total_loss(out: RenderOut, coeffs: Coeffs, target,
               gt_landmarks: Optional[torch.Tensor], bfm: DeviceBFM,
               cfg: FaceReconConfig,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of the terms. Returns (scalar, per-term dict)."""
    if out.skin is not None:
        # training render: the winner's skin corners rode the record, so
        # the interpolated skin mask arrives with the select
        mask = out.mask * out.skin
    else:
        mask = skin_mask_image(out, bfm)
    l_photo = photometric_loss(out.image, target, mask)
    l_reg = regularization_loss(coeffs, bfm, cfg)
    l_gamma = gamma_loss(coeffs.gamma)
    total = cfg.w_photo * l_photo + l_reg + cfg.w_gamma * l_gamma
    parts = {"photo": l_photo, "reg": l_reg, "gamma": l_gamma}
    if cfg.w_tex_var > 0.0:
        l_tv = texture_variance_loss(out.geometry.texture, bfm)
        total = total + cfg.w_tex_var * l_tv
        parts["tex_var"] = l_tv
    if gt_landmarks is not None:
        l_lmk = landmark_loss(out.geometry.landmarks2d, gt_landmarks, cfg)
        total = total + cfg.w_landmark * l_lmk
        parts["landmark"] = l_lmk
    parts["total"] = total
    return total, parts
