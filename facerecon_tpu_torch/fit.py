"""Coefficient-fitting driver (twin of facerecon_tpu/fit.py) — SURVEY.md §3
C17, workload config 4.

Analysis-by-synthesis: Adam steps directly on the coefficient vector of
one image (or a batch), optionally initialized by the CNN. Each step
renders through the differentiable training render (kernel K2 forward,
K3 backward) and the self-supervised losses. The per-step losses stay on
the device in one tensor, read once when the fit ends.

Targets come from disk (--images: a folder of photos with 68-landmark
side-cars, aligned on the host) or are rendered synthetically from known
coefficients (the default, which also yields recovery metrics). With
--out, the fitted mesh is exported per image as `<stem>_fit.obj`.

Usage:
  python -m facerecon_tpu_torch.fit --tiny --device cpu --steps 20
  python -m facerecon_tpu_torch.fit --steps 100 --out /tmp/fit_out
  python -m facerecon_tpu_torch.fit --images photos/ --landmarks --out /tmp/fit
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from facerecon_tpu_torch import resolve_device
from facerecon_tpu_torch.checkpoint import restore_or_init
from facerecon_tpu_torch.config import (FaceReconConfig, default_config,
                                        tiny_config)
from facerecon_tpu_torch.data.folder import FolderDataset
from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu_torch.ops.geometry import (DeviceBFM, coeffs_to_geometry,
                                              device_bfm)
from facerecon_tpu_torch.ops.losses import total_loss
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.pipeline import make_train_pipeline, regress_coeffs
from facerecon_tpu_torch.utils.bfm import synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff
from facerecon_tpu_torch.utils.metrics import landmark_rmse, psnr
from facerecon_tpu_torch.utils.obj_io import save_obj


class FitResult(NamedTuple):
    coeffs: torch.Tensor      # (B, n_coeff) final coefficients
    losses: torch.Tensor      # (steps,) total loss before each update
    final_parts: dict         # loss parts at the final coefficients


def make_fit_fn(cfg: FaceReconConfig, steps: int, lr: float = 5e-3):
    """(coeff0, bfm, target, gt_lmk) -> FitResult: `steps` Adam updates
    (constant lr, betas (0.9, 0.999), eps 1e-8, as optax.adam(lr)) of a
    leaf copy of coeff0 on the device of `bfm`. gt_lmk None drops the
    landmark term."""

    def loss_fn(coeff_vec, bfm, target, gt_lmk):
        coeffs = split_coeff(coeff_vec, cfg)
        out = render_coeffs(coeffs, bfm, cfg, background=target)
        return total_loss(out, coeffs, target, gt_lmk, bfm, cfg)

    def fit(coeff0, bfm: DeviceBFM, target, gt_lmk=None) -> FitResult:
        dev = bfm.faces.device
        target = torch.as_tensor(target, dtype=torch.float32, device=dev)
        if gt_lmk is not None:
            gt_lmk = torch.as_tensor(gt_lmk, dtype=torch.float32,
                                     device=dev)
        coeff = torch.as_tensor(coeff0, dtype=torch.float32, device=dev)
        coeff = coeff.detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([coeff], lr=lr, betas=(0.9, 0.999),
                               eps=1e-8)
        losses = torch.empty(steps, device=dev)
        for k in range(steps):
            opt.zero_grad(set_to_none=True)
            loss, _ = loss_fn(coeff, bfm, target, gt_lmk)
            loss.backward()
            opt.step()
            losses[k] = loss.detach()
        with torch.no_grad():
            _, parts = loss_fn(coeff, bfm, target, gt_lmk)
        return FitResult(coeffs=coeff.detach(), losses=losses,
                         final_parts=parts)

    return fit


def net_initial_coeffs(cfg: FaceReconConfig, assets, images, ckpt: str,
                       seed: int = 0, device="cuda") -> torch.Tensor:
    """CNN warm start for the fit (SURVEY.md §3 C17 "optionally
    net-initialized"): the BatchNorm model restored from a training
    checkpoint regresses coefficients in eval mode (running statistics),
    used as coeff0 instead of the mean face."""
    pipe = make_train_pipeline(cfg, assets, device=device)
    restore_or_init(pipe, ckpt, seed)
    with torch.no_grad():
        return regress_coeffs(pipe, images, train=False)


def run(args) -> dict:
    cfg = tiny_config() if args.tiny else default_config()
    dev = resolve_device(args.device)
    assets = synthetic_bfm(cfg, seed=0)
    bfm = device_bfm(assets, dev)
    rng = np.random.default_rng(args.seed)

    if args.images:
        # real-input workflow: folder of photos (+ 68-landmark side-cars),
        # aligned on the host exactly like the training pipeline
        ds = FolderDataset(args.images, cfg, align=args.align, assets=assets)
        target_np, lmk_np = ds.load_all()
        if args.landmarks and not np.isfinite(lmk_np).all():
            raise ValueError("--landmarks requested but some images have no "
                             "landmark side-car files")
        target = torch.as_tensor(target_np, device=dev)
        gt_lmk = torch.as_tensor(lmk_np, device=dev)
        names = ds.stems()
    else:
        # ground-truth synthetic target (yields recovery metrics)
        target, gt_lmk = render_batch(sample_coeffs(rng, cfg, args.batch),
                                      bfm, cfg)
        target_np, lmk_np = target.cpu().numpy(), gt_lmk.cpu().numpy()
        names = [f"synthetic_{i}" for i in range(args.batch)]
    # start from the mean face, or from the CNN's prediction when a
    # trained checkpoint is given
    if args.ckpt:
        coeff0 = net_initial_coeffs(cfg, assets, target, args.ckpt,
                                    args.seed, device=dev)
    else:
        coeff0 = torch.zeros((len(names), cfg.n_coeff), device=dev)

    fit = make_fit_fn(cfg, steps=args.steps, lr=args.lr)
    t0 = time.perf_counter()
    res = fit(coeff0, bfm, target, gt_lmk if args.landmarks else None)
    losses = res.losses.cpu().numpy()          # waits for the device
    elapsed = time.perf_counter() - t0

    with torch.no_grad():
        geom = coeffs_to_geometry(split_coeff(res.coeffs, cfg), bfm, cfg)
    final = render_batch(res.coeffs, bfm, cfg)[0].cpu().numpy()
    report = {
        "steps": args.steps, "batch": len(names), "fit_s": elapsed,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "monotone_95pct": bool(np.mean(np.diff(losses) <= 1e-4) > 0.9),
        "psnr_vs_target_db": psnr(final, target_np),
    }
    if np.isfinite(lmk_np).all():
        report["landmark_rmse_px"] = landmark_rmse(
            geom.landmarks2d.cpu().numpy(), lmk_np)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.save(os.path.join(args.out, "fitted_coeffs.npy"),
                res.coeffs.cpu().numpy())
        np.save(os.path.join(args.out, "loss_curve.npy"), losses)
        verts = geom.verts_world.cpu().numpy()
        tex = geom.texture.cpu().numpy()
        for i, name in enumerate(names):
            save_obj(os.path.join(args.out, f"{name}_fit.obj"),
                     verts[i], tex[i], assets.faces)
    print(json.dumps(report))
    return report


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--images", default=None,
                   help="folder of photos (+68-landmark side-cars) to fit; "
                        "omit for the synthetic recovery target")
    p.add_argument("--align", default="68pt",
                   choices=("5pt", "68pt", "none"),
                   help="alignment mode for --images")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--landmarks", action="store_true",
                   help="use ground-truth landmarks in the objective")
    p.add_argument("--ckpt", default=None,
                   help="training checkpoint directory: net-initialize "
                        "the fit")
    p.add_argument("--out", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to fit on (cuda, or cpu for the "
                        "plain PyTorch path)")
    return p.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
