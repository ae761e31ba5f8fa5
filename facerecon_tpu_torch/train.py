"""Self-supervised training driver (twin of facerecon_tpu/train.py).

Per step: batch -> BatchNorm ResNet (train mode) -> coefficient split ->
synthesis -> pose -> SH -> differentiable render (kernel K2 forward, K3
backward) -> composite -> photometric + landmark + regularization losses
-> backward -> Adam step with the reference's warmup-cosine schedule.

Usage:
  python -m facerecon_tpu_torch.train --steps 5 --tiny --device cpu
  python -m facerecon_tpu_torch.train --steps 200 --batch 128

Prints one JSON line per logged step (the loss parts and faces_per_sec)
and a final {"steps", "first_loss", "last_loss", "improved"} report, as
the reference does. The synthetic source renders on the training device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Callable, Dict

import torch

from facerecon_tpu_torch.config import (FaceReconConfig, default_config,
                                        tiny_config)
from facerecon_tpu_torch.data.synthetic import synthetic_batches
from facerecon_tpu_torch.ops.losses import total_loss
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.pipeline import (Pipeline, make_train_pipeline,
                                          regress_coeffs)
from facerecon_tpu_torch.utils.bfm import load_npz, synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff


def lr_schedule(cfg: FaceReconConfig, total_steps: int
                ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
    warmup_steps=min(1000, max(1, total_steps // 20)),
    decay_steps=max(2, total_steps)) as a function of the update count."""
    peak = cfg.learning_rate
    warmup = min(1000, max(1, total_steps // 20))
    decay = max(2, total_steps) - warmup

    def sched(count: int) -> float:
        if count < warmup:
            return -peak * (1.0 - count / warmup) + peak
        t = min(count - warmup, decay)
        return peak * (0.5 * (1.0 + math.cos(math.pi * t / decay)))

    return sched


def make_optimizer(cfg: FaceReconConfig, params, total_steps: int):
    """Adam (b1 0.9, b2 0.999, eps 1e-8) on the warmup-cosine schedule.

    optax evaluates the schedule at the update count BEFORE the update,
    so the first update uses lr = sched(0) = 0. A LambdaLR starts at
    lambda(0) and is stepped after each update, which gives the same
    counts."""
    sched = lr_schedule(cfg, total_steps)
    opt = torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: sched(k) / cfg.learning_rate)


@dataclasses.dataclass
class TrainState:
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def init_state(pipe: Pipeline, total_steps: int, seed: int = 0
               ) -> TrainState:
    """Initialise the model's weights from `seed` (as the reference's
    init does) and a fresh optimizer."""
    pipe.model.reset_parameters_(torch.Generator().manual_seed(seed))
    opt, sched = make_optimizer(pipe.cfg, pipe.model.parameters(),
                                total_steps)
    return TrainState(optimizer=opt, scheduler=sched)


def make_train_step(pipe: Pipeline, use_landmarks: bool = True):
    """(state, images, gt_lmk) -> per-term losses of the step (detached
    0-d tensors). Runs the forward in train mode (the BN running
    statistics update in place), the backward and one Adam update."""
    cfg, bfm = pipe.cfg, pipe.bfm

    def step(state: TrainState, images, gt_lmk) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        coeffs = split_coeff(regress_coeffs(pipe, images, train=True), cfg)
        out = render_coeffs(coeffs, bfm, cfg, background=images)
        total, parts = total_loss(out, coeffs, images,
                                  gt_lmk if use_landmarks else None, bfm,
                                  cfg)
        total.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {k: v.detach() for k, v in parts.items()}

    return step


def run(args) -> dict:
    cfg = tiny_config() if args.tiny else default_config()
    if args.batch:
        cfg = dataclasses.replace(cfg, batch_size=args.batch)
    assets = load_npz(args.bfm) if args.bfm else synthetic_bfm(cfg, seed=0)
    pipe = make_train_pipeline(cfg, assets, device=args.device)
    state = init_state(pipe, args.steps, args.seed)
    train_step = make_train_step(pipe, use_landmarks=not args.no_landmarks)
    data = synthetic_batches(pipe.bfm, cfg, cfg.batch_size,
                             seed=args.seed + 1, pool=args.data_pool)

    first_loss = last_loss = None
    t0 = time.perf_counter()
    for i in range(args.steps):
        images, lmk, _ = next(data)
        parts = train_step(state, images, lmk)
        if i == 0:
            # the first step builds the kernels: the rate times the rest
            first_loss = float(parts["total"])      # waits for the device
            t0 = time.perf_counter()
        if (i + 1) % args.log_every == 0 or i == args.steps - 1:
            last_loss = float(parts["total"])
            rate = (cfg.batch_size * i / (time.perf_counter() - t0)
                    if i > 0 else float("nan"))
            print(json.dumps({
                "step": i + 1,
                **{k: round(float(v), 5) for k, v in parts.items()},
                "faces_per_sec": round(rate, 1)}))
    report = {"steps": state.step, "first_loss": first_loss,
              "last_loss": last_loss,
              "improved": (first_loss is None or last_loss is None
                           or last_loss < first_loss)}
    print(json.dumps(report))
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--data-pool", type=int, default=0,
                   help="synthetic source: render this many batches once "
                        "and epoch over them (0 = a fresh render each "
                        "step)")
    p.add_argument("--bfm", default=None)
    p.add_argument("--no-landmarks", action="store_true")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu for the "
                        "plain PyTorch path)")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    main()
