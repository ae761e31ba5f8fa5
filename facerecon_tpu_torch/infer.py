"""Inference/demo driver (twin of facerecon_tpu/infer.py) — SURVEY.md §3
C16, workload config 1.

image(s) -> coefficients, 68 landmarks, rendered face, exported .obj.
With --synthetic (the default when no images are given) it generates
ground-truth faces from random coefficients and reports recovery
metrics. The BatchNorm regressor is restored from a training checkpoint
(--ckpt; fresh weights without one) and, with --fused, folded into the
BN-free fused model. The render is the training render's select path
(kernel K2), as the reference's infer renders.

Usage:
  python -m facerecon_tpu_torch.infer --tiny --device cpu --synthetic 2 --out /tmp/o
  python -m facerecon_tpu_torch.infer --out /tmp/out --synthetic 4 --fused
  python -m facerecon_tpu_torch.infer --images img1.png img2.png --ckpt ck/
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from facerecon_tpu_torch.checkpoint import restore_or_init
from facerecon_tpu_torch.config import (FaceReconConfig, default_config,
                                        tiny_config)
from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu_torch.pipeline import (fuse_for_inference,
                                          make_train_pipeline)
from facerecon_tpu_torch.utils.bfm import BFMAssets, load_npz, synthetic_bfm
from facerecon_tpu_torch.utils.metrics import landmark_rmse, psnr
from facerecon_tpu_torch.utils.obj_io import save_obj


def load_image(path: str, size: int) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB").resize((size, size))
    return np.asarray(img, np.float32) / 255.0


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def landmark_overlay(image: np.ndarray, lmk: np.ndarray,
                     radius: int = 1) -> np.ndarray:
    """Landmark overlay plot (SURVEY.md §2 L7): green dots on the image."""
    out = np.array(image, dtype=np.float32, copy=True)
    h, w = out.shape[:2]
    for x, y in lmk:
        xi, yi = int(round(x)), int(round(y))
        y0, y1 = max(yi - radius, 0), min(yi + radius + 1, h)
        x0, x1 = max(xi - radius, 0), min(xi + radius + 1, w)
        if y0 < y1 and x0 < x1:
            out[y0:y1, x0:x1] = np.array([0.0, 1.0, 0.0])
    return out


def depth_to_image(mask: np.ndarray, verts_ndc: np.ndarray,
                   tri_id: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Depth dump (SURVEY.md §2 L7): normalized inverse depth, gray ramp.

    Per-pixel depth approximated by the winning triangle's mean vertex depth
    (sub-triangle precision is irrelevant for a visualization dump)."""
    depth = verts_ndc[:, 2]
    tri_depth3 = depth[faces[np.maximum(tri_id, 0)]]    # (H,W,3)
    tri_depth = np.where(mask, tri_depth3.mean(-1), np.nan)
    lo, hi = np.nanmin(tri_depth), np.nanmax(tri_depth)
    norm = np.where(mask, 1.0 - (tri_depth - lo) / max(hi - lo, 1e-6), 0.0)
    return np.repeat(norm[..., None], 3, axis=-1)


def get_assets(args, cfg: FaceReconConfig) -> BFMAssets:
    if args.bfm:
        return load_npz(args.bfm)
    return synthetic_bfm(cfg, seed=0)


def run(args) -> dict:
    cfg = tiny_config() if args.tiny else default_config()
    assets = get_assets(args, cfg)
    pipe = make_train_pipeline(cfg, assets, device=args.device)
    restore_or_init(pipe, args.ckpt)
    if args.fused:
        # serving transform: fold BN + space-to-depth stem (exact)
        pipe = fuse_for_inference(pipe)
    os.makedirs(args.out, exist_ok=True)

    if args.images:
        images = np.stack([load_image(p, cfg.image_size)
                           for p in args.images])
        names = [os.path.splitext(os.path.basename(p))[0]
                 for p in args.images]
        gt_lmk = None
    else:
        rng = np.random.default_rng(args.seed)
        images, gt_lmk = (t.cpu().numpy() for t in render_batch(
            sample_coeffs(rng, cfg, args.synthetic), pipe.bfm, cfg))
        names = [f"synthetic_{i}" for i in range(args.synthetic)]

    t0 = time.perf_counter()
    coeff_vec, _, out = pipe.reconstruct(images, inference=False)
    coeff_vec = coeff_vec.cpu().numpy()          # waits for the device
    elapsed = time.perf_counter() - t0

    verts, tex, lmk, vndc = (t.cpu().numpy() for t in (
        out.geometry.verts_world, out.geometry.texture,
        out.geometry.landmarks2d, out.geometry.verts_ndc))
    rendered, tri_id = out.image.cpu().numpy(), out.tri_id.cpu().numpy()

    report = {"n_images": len(names), "forward_s": elapsed}
    for i, name in enumerate(names):
        save_obj(os.path.join(args.out, f"{name}.obj"),
                 verts[i], tex[i], assets.faces)
        save_image(os.path.join(args.out, f"{name}_render.png"), rendered[i])
        np.savetxt(os.path.join(args.out, f"{name}_landmarks.txt"), lmk[i],
                   fmt="%.4f")
        np.save(os.path.join(args.out, f"{name}_coeffs.npy"), coeff_vec[i])
        if args.overlay:
            save_image(os.path.join(args.out, f"{name}_overlay.png"),
                       landmark_overlay(images[i], lmk[i]))
        if args.depth:
            save_image(os.path.join(args.out, f"{name}_depth.png"),
                       depth_to_image(tri_id[i] >= 0, vndc[i], tri_id[i],
                                      assets.faces))
    if gt_lmk is not None:
        report["landmark_rmse_px"] = landmark_rmse(lmk, gt_lmk)
        report["render_psnr_db"] = psnr(np.clip(rendered, 0, 1), images)
    print(json.dumps(report))
    return report


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", nargs="*", default=None,
                   help="aligned face images; omit for --synthetic")
    p.add_argument("--synthetic", type=int, default=4,
                   help="number of synthetic faces when no images given")
    p.add_argument("--out", default="/tmp/facerecon_out")
    p.add_argument("--ckpt", default=None,
                   help="training checkpoint directory to restore")
    p.add_argument("--fused", action="store_true",
                   help="serve the inference-fused CNN (BN folded, "
                        "space-to-depth stem; exact to float32 rounding)")
    p.add_argument("--bfm", default=None, help=".npz BFM asset pack")
    p.add_argument("--tiny", action="store_true", help="tiny test config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--overlay", action="store_true",
                   help="save landmark overlay plots")
    p.add_argument("--depth", action="store_true", help="save depth dumps")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu for the "
                        "plain PyTorch path)")
    return p.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
