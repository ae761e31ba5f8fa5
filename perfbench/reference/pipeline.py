"""The reference's reconstruction and training step, composed from the
plain parts: images -> ResNet-50 -> coefficients -> geometry -> SH
radiance -> z-buffer -> the winner's barycentric shading -> composite
over the background; and the losses, their gradients and Adam on the
warmup-cosine schedule."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from perfbench.reference import cnn, geometry as geo, losses, raster


class Render(NamedTuple):
    geometry: geo.Geometry
    tri_id: torch.Tensor     # (B, H, W) int64, -1 background
    bary: torch.Tensor       # (B, H, W, 3)
    color: torch.Tensor      # (B, H, W, 3) zero on background
    skin: torch.Tensor       # (B, H, W) interpolated skin weight
    mask: torch.Tensor       # (B, H, W) coverage
    image: torch.Tensor      # (B, H, W, 3) composited


def render(coeff, mesh, cam: dict, sizes: dict, background=None,
           precision: str = "f32", tri_id=None) -> Render:
    """coefficients (B, n_coeff) -> the composited render. tri_id, where
    given, replaces the z-buffer's (to shade another side's winners)."""
    g = geo.geometry(coeff, mesh, cam, sizes, precision)
    size = cam["image_size"]
    if tri_id is None:
        with torch.no_grad():
            tri_id = raster.winners(g.screen, g.depth, mesh.faces, size,
                                    size)
    skin = mesh.skin_mask[None, :, None].expand(coeff.shape[0], -1, 1)
    bary, (color, sk) = raster.shade(tri_id, mesh.faces, g.screen,
                                     (g.radiance, skin))
    mask = (tri_id >= 0).to(torch.float32)
    if background is None:
        background = torch.zeros_like(color)
    image = color * mask[..., None] + background * (1.0 - mask[..., None])
    return Render(geometry=g, tri_id=tri_id, bary=bary, color=color,
                  skin=sk[..., 0], mask=mask, image=image)


def loss_parts(params, images, lmk, mesh, cam, sizes, lw,
               cnn_precision="f32", geo_precision="f32"):
    """({part: 0-d tensor}, the coefficients the CNN regressed)."""
    coeff = cnn.regress(params, images, train=True, precision=cnn_precision)
    r = render(coeff, mesh, cam, sizes, background=images,
               precision=geo_precision)
    cid, cexp, ctex, _, gamma, _ = geo.split(coeff, sizes)
    parts = {"photo": losses.photometric(r.image, images, r.mask * r.skin),
             "reg": losses.regularization(cid, cexp, ctex, mesh, lw),
             "gamma": losses.gamma_balance(gamma),
             "landmark": losses.landmark(r.geometry.landmarks, lmk,
                                         cam["image_size"],
                                         lw["landmark_weight_inner"])}
    parts["total"] = losses.total(parts, lw)
    return parts, coeff


def schedule(opt: dict):
    """Warmup from 0 to lr over min(1000, max(1, total // 20)) updates,
    then cosine decay to 0 at max(2, total); a function of the update
    count before the update."""
    peak, total = opt["lr"], opt["total_steps"]
    warm = min(1000, max(1, total // 20))
    decay = max(2, total) - warm

    def lr(count: int) -> float:
        if count < warm:
            return -peak * (1.0 - count / warm) + peak
        t = min(count - warm, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))
    return lr


class TrainReadings(NamedTuple):
    losses: list          # per step: {part: float}
    grad_norms: dict      # leaf -> norm of the first step's gradient
    change_norms: dict    # leaf -> norm of (after the last step - start)
    coeff: torch.Tensor   # the first step's coefficients (B, n_coeff)


def train(params, trainable, batches, mesh, cam, sizes, lw, opt: dict,
          cnn_precision="f32", geo_precision="f32") -> TrainReadings:
    """Steps of Adam (b1, b2, eps from `opt`) on `trainable` leaves of
    `params`, one a batch (images, landmarks), from the given leaves."""
    lr = schedule(opt)
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    p = {k: (v.detach().clone().requires_grad_(k in trainable)
             if k in trainable else v) for k, v in params.items()}
    start = {k: p[k].detach().clone() for k in trainable}
    m = {k: torch.zeros_like(start[k]) for k in trainable}
    v = {k: torch.zeros_like(start[k]) for k in trainable}
    readings, grad_norms = [], {}
    for t, (images, lmk) in enumerate(batches, start=1):
        parts, coeff = loss_parts(p, images, lmk, mesh, cam, sizes, lw,
                                  cnn_precision, geo_precision)
        if t == 1:
            first = coeff.detach().clone()
        grads = torch.autograd.grad(parts["total"], [p[k] for k in trainable])
        readings.append({k: float(x) for k, x in parts.items()})
        with torch.no_grad():
            for k, g in zip(trainable, grads):
                if t == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(
                        g.double()))
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p[k].addcdiv_(m[k], denom, value=-lr(t - 1) / (1 - b1 ** t))
        del grads
    change = {k: float(torch.linalg.vector_norm((p[k].detach() - start[k])
                                                .double()))
              for k in trainable}
    return TrainReadings(readings, grad_norms, change, first)
