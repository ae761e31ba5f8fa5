"""Video-sequence face tracking driver (twin of facerecon_tpu/track.py) —
SURVEY.md §3 C19, workload config 5.

Two stages:
  1. per-frame CNN regression: the BatchNorm regressor in eval mode,
     from a training checkpoint (--ckpt) or freshly initialised (zero
     head -> the mean face), then EMA-smoothed over pose and expression;
  2. refinement by Adam on the coefficients, each step rendering through
     the differentiable training render (kernel K2 forward, K3
     backward) and the self-supervised losses with landmarks:
       - joint (the default): identity and texture coefficients are
         SHARED across the sequence and solved jointly, per-frame
         expression, pose, lighting and translation stay free; a step
         renders all T frames;
       - sequential (--sequential): online tracking, each frame in turn
         from a blend of the CNN's prediction and the previous frame's
         result, with an Adam state of its own; a step renders 1 frame.
The per-step losses stay on the device, read once when the solve ends.

Under `python -m torch.distributed.run` (parallel/mesh.py) the joint
solve shards the frames over the ranks when T divides by the world size,
as the reference shards them over its mesh: the shared coefficients are
replicated and their gradient summed over the ranks, each rank holds
its frames' per-frame coefficients, and each rank's loss is its frames'
sum over the global T, so the ranks together solve the reference's
objective exactly.

Usage:
  python -m facerecon_tpu_torch.track --tiny --device cpu --frames 8 \\
      --refine-steps 30
  python -m facerecon_tpu_torch.track --frames 16 --refine-steps 100
  python -m facerecon_tpu_torch.track --frames-dir frames/ --out /tmp/t
  python -m facerecon_tpu_torch.track --video clip.avi \\
      --video-landmarks clip_lmk.npy --align none
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from facerecon_tpu_torch.checkpoint import restore_or_init
from facerecon_tpu_torch.config import (FaceReconConfig, default_config,
                                        tiny_config)
from facerecon_tpu_torch.data.folder import FolderDataset
from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu_torch.data.video import load_video
from facerecon_tpu_torch.ops.geometry import DeviceBFM, coeffs_to_geometry
from facerecon_tpu_torch.ops.losses import total_loss
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.parallel import mesh
from facerecon_tpu_torch.pipeline import make_train_pipeline, regress_coeffs
from facerecon_tpu_torch.utils.bfm import load_npz, synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff
from facerecon_tpu_torch.utils.metrics import landmark_rmse, psnr


class TrackParams(NamedTuple):
    """Joint-solve parameterization: shared appearance, free per-frame rest."""
    shared_id: torch.Tensor    # (K_id,)
    shared_tex: torch.Tensor   # (K_tex,)
    per_frame: torch.Tensor    # (T, K_exp + 3 + 27 + 3)


def _assemble(tp: TrackParams, cfg: FaceReconConfig) -> torch.Tensor:
    """TrackParams -> full (T, n_coeff) coefficient matrix."""
    t = tp.per_frame.shape[0]
    n_exp = cfg.n_exp
    return torch.cat([tp.shared_id.expand(t, cfg.n_id),
                      tp.per_frame[:, :n_exp],
                      tp.shared_tex.expand(t, cfg.n_tex),
                      tp.per_frame[:, n_exp:]], dim=-1)


def _decompose(coeff: torch.Tensor, cfg: FaceReconConfig) -> TrackParams:
    s = cfg.coeff_split
    return TrackParams(
        shared_id=coeff[:, :s[0]].mean(dim=0),
        shared_tex=coeff[:, s[1]:s[2]].mean(dim=0),
        per_frame=torch.cat([coeff[:, s[0]:s[1]], coeff[:, s[2]:]], dim=-1))


def _adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, constant lr."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _on(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def make_refine_fn(cfg: FaceReconConfig, steps: int, lr: float = 5e-3,
                   sharded: bool = False):
    """(tp0, bfm, frames, lmk) -> (TrackParams, losses (steps,)): `steps`
    Adam updates of leaf copies of tp0's three tensors on the device of
    `bfm`, each on the total loss of every frame.

    sharded: frames, lmk and tp0.per_frame are this rank's equal slice of
    the sequence (mesh.shard_batch). Each rank's loss is then its frames'
    sum over the global T (its mean / world size), the shared leaves'
    gradients are summed over the ranks and the per-frame leaf's stay
    local; the returned losses are the global ones."""

    def loss_fn(tp: TrackParams, bfm, frames, lmk):
        coeffs = split_coeff(_assemble(tp, cfg), cfg)
        out = render_coeffs(coeffs, bfm, cfg, background=frames)
        return total_loss(out, coeffs, frames, lmk, bfm, cfg)[0]

    def refine(tp0: TrackParams, bfm: DeviceBFM, frames, lmk):
        dev = bfm.faces.device
        frames, lmk = _on(frames, dev), _on(lmk, dev)
        tp = TrackParams(*(_on(x, dev).detach().clone().requires_grad_(True)
                           for x in tp0))
        opt = _adam(tp, lr)
        share = 1.0 / mesh.world() if sharded else 1.0
        losses = torch.empty(steps, device=dev)
        for k in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(tp, bfm, frames, lmk) * share
            loss.backward()
            if sharded:
                mesh.all_reduce_grads(tp[:2], "sum")
            opt.step()
            losses[k] = loss.detach()
        if sharded:
            losses = mesh.all_reduce(losses)
        return TrackParams(*(x.detach() for x in tp)), losses

    return refine


def make_sequential_fn(cfg: FaceReconConfig, steps: int, lr: float = 5e-3,
                       warm: float = 0.5):
    """Online per-frame tracking (SURVEY.md §4.5 "warm-start from prev"):
    (cnn_coeffs, bfm, frames, lmks) -> (coeffs (T, n_coeff), losses
    (T, steps)). Each frame's coefficients are refined by `steps` Adam
    steps, a fresh Adam state a frame, initialized from a blend of the
    CNN's prediction and the PREVIOUS frame's result (frame 0 from the
    CNN's alone) — the classic streaming-tracking loop."""

    def frame_loss(coeff_vec, bfm, frame, lmk):
        coeffs = split_coeff(coeff_vec[None], cfg)
        out = render_coeffs(coeffs, bfm, cfg, background=frame[None])
        return total_loss(out, coeffs, frame[None], lmk[None], bfm, cfg)[0]

    def track(cnn_coeffs, bfm: DeviceBFM, frames, lmks):
        dev = bfm.faces.device
        cnn = _on(cnn_coeffs, dev)
        frames, lmks = _on(frames, dev), _on(lmks, dev)
        coeffs = torch.empty_like(cnn)
        losses = torch.empty((cnn.shape[0], steps), device=dev)
        for t in range(cnn.shape[0]):
            init = (cnn[0] if t == 0
                    else warm * cnn[t] + (1.0 - warm) * coeffs[t - 1])
            coeff = init.detach().clone().requires_grad_(True)
            opt = _adam([coeff], lr)
            for k in range(steps):
                opt.zero_grad(set_to_none=True)
                loss = frame_loss(coeff, bfm, frames[t], lmks[t])
                loss.backward()
                opt.step()
                losses[t, k] = loss.detach()
            coeffs[t] = coeff.detach()
        return coeffs, losses

    return track


def smooth_coeffs(coeff: np.ndarray, cfg: FaceReconConfig,
                  alpha: float = 0.6) -> np.ndarray:
    """EMA temporal smoothing of pose/expression across frames."""
    out = coeff.copy()
    s = cfg.coeff_split
    for t in range(1, coeff.shape[0]):
        out[t, s[2]:] = alpha * out[t, s[2]:] + (1 - alpha) * out[t - 1, s[2]:]
    return out


def _sources(args, cfg, assets, bfm, rng):
    """(frames, landmarks, generating coefficients or None, base or
    None) from --video, --frames-dir or the synthetic sequence."""
    if args.video:
        # raw footage: decode + align in one step (SURVEY.md §2 L6);
        # landmarks come as ONE (T,68,2) side file for the clip
        frames, gt_lmk = load_video(
            args.video, cfg, landmarks=args.video_landmarks,
            align=args.align, assets=assets, max_frames=args.max_frames,
            stride=args.stride)
        if not np.isfinite(gt_lmk).all():
            raise ValueError("tracking needs a --video-landmarks track "
                             "(the refinement objective uses the landmark "
                             "loss)")
        return frames, gt_lmk, None, None
    if args.frames_dir:
        # an ordered folder of extracted frames with 68-landmark
        # side-cars, aligned on the host like the training pipeline
        frames, gt_lmk = FolderDataset(args.frames_dir, cfg,
                                       align=args.align,
                                       assets=assets).load_all()
        if not np.isfinite(gt_lmk).all():
            raise ValueError("tracking needs landmark side-car files for "
                             "every frame (the refinement objective uses "
                             "the landmark loss)")
        return frames, gt_lmk, None, None
    # synthetic sequence: one identity/texture, smooth-varying pose+exp
    base = sample_coeffs(rng, cfg, 1)[0]
    t_ax = np.linspace(0, 2 * np.pi, args.frames, dtype=np.float32)
    seq = np.tile(base, (args.frames, 1))
    s = cfg.coeff_split
    seq[:, s[0]:s[1]] += (0.15 * np.sin(t_ax)[:, None]
                          * rng.standard_normal(
                              (1, cfg.n_exp)).astype(np.float32))
    seq[:, s[2]] += 0.2 * np.sin(t_ax)          # yaw sweep
    frames, gt_lmk = render_batch(seq, bfm, cfg)
    return frames, gt_lmk, seq, base


def run(args) -> dict:
    cfg = tiny_config() if args.tiny else default_config()
    dev = mesh.init(args.device)
    lead = mesh.rank() == 0           # rank 0 alone prints and writes
    assets = load_npz(args.bfm) if args.bfm else synthetic_bfm(cfg, seed=0)
    pipe = make_train_pipeline(cfg, assets, device=dev)
    bfm = pipe.bfm
    rng = np.random.default_rng(args.seed)
    frames, gt_lmk, seq, base = _sources(args, cfg, assets, bfm, rng)
    frames, gt_lmk = _on(frames, dev), _on(gt_lmk, dev)
    n_frames = frames.shape[0]

    # stage 1: per-frame CNN regression (eval mode) from a trained
    # checkpoint (--ckpt) or a fresh init
    restore_or_init(pipe, args.ckpt, args.seed)
    with torch.no_grad():
        coeff0 = regress_coeffs(pipe, frames, train=False).cpu().numpy()
    coeff0 = smooth_coeffs(coeff0, cfg)

    if args.sequential:
        # online mode: per-frame fit warm-started from the previous frame
        track_fn = make_sequential_fn(cfg, steps=args.refine_steps,
                                      lr=args.lr, warm=args.warm_alpha)
        t0 = time.perf_counter()
        coeff_fit, seq_losses = track_fn(coeff0, bfm, frames, gt_lmk)
        losses = seq_losses[:, -1].cpu().numpy()   # final loss per frame
        elapsed = time.perf_counter() - t0
        tp = _decompose(coeff_fit, cfg)
        n_dev = 1
    else:
        # stage 2: joint refinement, frames sharded over the ranks
        n_dev = mesh.world()
        sharded = n_dev > 1 and n_frames % n_dev == 0
        tp0 = _decompose(_on(coeff0, dev), cfg)
        mesh.replicate(tp0[:2])
        f_in, l_in = frames, gt_lmk
        if sharded:
            f_in, l_in, per_frame = mesh.shard_batch(
                (frames, gt_lmk, tp0.per_frame))
            tp0 = tp0._replace(per_frame=per_frame)
        refine = make_refine_fn(cfg, steps=args.refine_steps, lr=args.lr,
                                sharded=sharded)
        t0 = time.perf_counter()
        tp, losses = refine(tp0, bfm, f_in, l_in)
        losses = losses.cpu().numpy()
        elapsed = time.perf_counter() - t0
        if sharded:
            tp = tp._replace(per_frame=mesh.unshard_batch(tp.per_frame))
        coeff_fit = _assemble(tp, cfg)
    with torch.no_grad():
        tracked = render_batch(coeff_fit, bfm, cfg)[0]
        out = render_coeffs(split_coeff(coeff_fit, cfg), bfm, cfg)
    lmk2d = out.geometry.landmarks2d.cpu().numpy()
    report = {
        "frames": n_frames, "devices": n_dev,
        "refine_s": elapsed,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "psnr_db": psnr(tracked.cpu().numpy(), frames.cpu().numpy()),
        "landmark_rmse_px": landmark_rmse(lmk2d, gt_lmk.cpu().numpy()),
    }
    if seq is not None:
        # per-frame geometry recovery vs the generating sequence (synthetic
        # source only). With synthetic random-orthonormal bases, identity
        # COEFFICIENTS are not identifiable (the id and exp spans alias):
        # the recovered SHAPE is the meaningful metric; id_err is reported
        # for information only.
        with torch.no_grad():
            gt_geom = coeffs_to_geometry(split_coeff(_on(seq, dev), cfg),
                                         bfm, cfg)
        report["vertex_mae"] = float(
            (out.geometry.verts_world - gt_geom.verts_world).abs().mean())
        report["id_err"] = float(np.abs(tp.shared_id.cpu().numpy()
                                        - base[:cfg.n_id]).mean())
    if args.out and lead:
        os.makedirs(args.out, exist_ok=True)
        np.save(os.path.join(args.out, "tracked_coeffs.npy"),
                coeff_fit.cpu().numpy())
        np.save(os.path.join(args.out, "tracked_landmarks.npy"), lmk2d)
    if lead:
        print(json.dumps(report))
    return report


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--frames-dir", default=None,
                   help="ordered folder of video frames (+68-landmark "
                        "side-cars) to track; omit for the synthetic "
                        "sequence")
    p.add_argument("--video", default=None,
                   help="video file to decode and track (cv2-readable); "
                        "pair with --video-landmarks")
    p.add_argument("--video-landmarks", default=None,
                   help="(T,68,2) .npy or flat-text landmark track for "
                        "--video")
    p.add_argument("--max-frames", type=int, default=None,
                   help="--video: cap decoded frame count")
    p.add_argument("--stride", type=int, default=1,
                   help="--video: keep every k-th frame")
    p.add_argument("--align", default="68pt",
                   choices=("5pt", "68pt", "none"),
                   help="alignment mode for --frames-dir and --video")
    p.add_argument("--out", default=None,
                   help="directory for tracked coefficient/landmark dumps")
    p.add_argument("--refine-steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--ckpt", default=None,
                   help="training checkpoint directory for stage-1 "
                        "regression")
    p.add_argument("--sequential", action="store_true",
                   help="online per-frame fit warm-started from the "
                        "previous frame (instead of the joint solve)")
    p.add_argument("--warm-alpha", type=float, default=0.5,
                   help="sequential mode: CNN vs previous-frame blend")
    p.add_argument("--bfm", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to track on (cuda, or cpu for the "
                        "plain PyTorch path)")
    return p.parse_args(argv)


def main(argv=None):
    try:
        return run(parse_args(argv))
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
