"""Self-supervised training driver (twin of facerecon_tpu/train.py).

Per step: batch -> BatchNorm ResNet (train mode) -> coefficient split ->
synthesis -> pose -> SH -> differentiable render (kernel K2 forward, K3
backward) -> composite -> photometric + landmark + regularization losses
-> backward -> Adam step with the reference's warmup-cosine schedule.

Usage:
  python -m facerecon_tpu_torch.train --steps 5 --tiny --device cpu
  python -m facerecon_tpu_torch.train --steps 200 --batch 128
  python -m facerecon_tpu_torch.train --data-dir photos/ --batch 32 \
      --ckpt-dir ck/ [--resume]

Data parallel, one process a device (parallel/mesh.py; nccl on cuda,
gloo on the CPU):
  python -m torch.distributed.run --standalone --nproc-per-node N \
      -m facerecon_tpu_torch.train --batch 64 ...
Every rank builds the same model from --seed (and takes rank 0's by a
broadcast), draws the same global batch and loads, and trains on, only
its slice of it;
the gradients and the logged losses are all-reduced means, and rank 0
alone writes checkpoints, JSON lines and TensorBoard.

Prints one JSON line per logged step (the loss parts and faces_per_sec)
and a final {"steps", "first_loss", "last_loss", "improved"} report, as
the reference does. Batches come from a folder of photos with landmark
side-cars (--data-dir, aligned on the host) or from the synthetic source
(rendered on the training device), through a background prefetch thread,
which also quantizes host batches for the wire: they cross to the card
as uint8 (--wire-f32: float32).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from facerecon_tpu_torch.checkpoint import CheckpointManager
from facerecon_tpu_torch.config import (FaceReconConfig, default_config,
                                        tiny_config)
from facerecon_tpu_torch.data.feeder import prefetch
from facerecon_tpu_torch.data.folder import FolderDataset
from facerecon_tpu_torch.data.synthetic import synthetic_batches
from facerecon_tpu_torch.ops.losses import total_loss
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.parallel import mesh
from facerecon_tpu_torch.pipeline import (Pipeline, make_train_pipeline,
                                          regress_coeffs)
from facerecon_tpu_torch.profile_trace import mark, recording, span
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


def _mark_coeff_grad(_grad):
    """Gradient hook on the regressor's output, set while a profiler
    records: the coefficients' gradient is complete, so the render's
    backward has been launched and the CNN's is next (the mark
    fr.coeff_grad, on the autograd engine's thread)."""
    mark("fr.coeff_grad")


def make_train_step(pipe: Pipeline, use_landmarks: bool = True):
    """(state, images, gt_lmk) -> per-term losses of the step (detached
    0-d tensors). Runs the forward in train mode (the BN running
    statistics update in place), the backward and one Adam update.

    In a process group (parallel/mesh.py) images and gt_lmk are this
    rank's slice of the global batch: the gradients are all-reduced
    (mean) between the backward and the update, and the returned parts
    are the all-reduced means.

    While a profiler records, the step's stages are spans of the trace
    (profile_trace.span): fr.cnn, fr.render, fr.losses, fr.backward cut
    by the mark fr.coeff_grad, fr.optimizer."""
    cfg, bfm = pipe.cfg, pipe.bfm
    params = list(pipe.model.parameters())

    def step(state: TrainState, images, gt_lmk) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        coeff_vec = regress_coeffs(pipe, images, train=True)
        if recording():
            coeff_vec.register_hook(_mark_coeff_grad)
        coeffs = split_coeff(coeff_vec, cfg)
        out = render_coeffs(coeffs, bfm, cfg, background=images)
        with span("fr.losses"):
            total, parts = total_loss(out, coeffs, images,
                                      gt_lmk if use_landmarks else None,
                                      bfm, cfg)
        with span("fr.backward"):
            total.backward()
        parts = {k: v.detach() for k, v in parts.items()}
        if mesh.grouped():
            # every term is a mean over images (ops/losses.py), so on
            # equal shards the mean of the ranks' means is the global
            # batch's mean, and so is the mean of their gradients
            mesh.all_reduce_grads(params, "mean")
            vals = mesh.all_reduce(torch.stack(list(parts.values())))
            parts = dict(zip(parts, vals / mesh.world()))
        with span("fr.optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        return parts

    return step


def save_state(mgr: CheckpointManager, pipe: Pipeline,
               state: TrainState) -> None:
    """Checkpoint the model, Adam, the schedule and the step count."""
    mgr.save(state.step, {"model": pipe.model.state_dict(),
                          "optimizer": state.optimizer.state_dict(),
                          "scheduler": state.scheduler.state_dict(),
                          "step": state.step})


def restore_state(mgr: CheckpointManager, pipe: Pipeline,
                  state: TrainState, step: Optional[int] = None) -> None:
    """Load a checkpoint (the latest when step is None) into the model,
    Adam, the schedule and the step count. The schedule's function stays
    the one `state` was built with (as the reference rebuilds its
    optimizer from --steps); its update count comes from the file."""
    saved = mgr.restore(step)
    pipe.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step = int(saved["step"])


def host_wire(images, wire_u8: bool = True):
    """The host half of the wire, run on the feeder thread: a host (numpy)
    batch of float images in [0,1] -> uint8 (a quarter of float32's
    bytes), or float32 when wire_u8 is False. Values are clipped to [0,1]
    before they are quantized: the reference quantizes unclipped values,
    which wrap modulo 256 (facerecon_tpu/train.py:188). A tensor (the
    synthetic source renders on the device) passes as it is."""
    if isinstance(images, torch.Tensor):
        return images
    if wire_u8:
        return (np.clip(images, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(images, dtype=np.float32)


def stage_images(images, device: torch.device):
    """The device half of the wire: a batch from host_wire -> float32
    [0,1] on `device`. A host batch crosses from pinned memory with a
    non_blocking copy; a uint8 one is divided by 255 in float32 on the
    device. A tensor is moved as it is."""
    if isinstance(images, torch.Tensor):
        return images.to(device)
    host = torch.from_numpy(np.ascontiguousarray(images))
    if device.type == "cuda":
        host = host.pin_memory()
    dev = host.to(device, non_blocking=True)
    return dev.to(torch.float32) / 255.0 if dev.dtype == torch.uint8 else dev


def _tensorboard(logdir: Optional[str]):
    """A SummaryWriter for `logdir`, or None (an optional sink: the run
    carries on without it, as the reference's does)."""
    if not logdir:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logdir)
    except Exception as e:
        print(f"tensorboard writer unavailable: {e}")
        return None


def run(args) -> dict:
    """Train as the parsed flags say."""
    cfg = tiny_config() if args.tiny else default_config()
    if args.batch:
        cfg = dataclasses.replace(cfg, batch_size=args.batch)
    assets = load_npz(args.bfm) if args.bfm else synthetic_bfm(cfg, seed=0)
    device = mesh.init(args.device)
    lead = mesh.rank() == 0           # rank 0 alone prints and writes
    pipe = make_train_pipeline(cfg, assets, device=device)
    state = init_state(pipe, args.steps, args.seed)
    mesh.replicate(pipe.model)
    train_step = make_train_step(pipe, use_landmarks=not args.no_landmarks)
    chunk = max(1, args.chunk)

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            restore_state(mgr, pipe, state)      # the same file on every rank
            if lead:
                print(f"resumed at step {state.step}")
    writer = _tensorboard(args.tensorboard) if lead else None

    # every rank draws the same global batches and loads (decodes or
    # renders) only its slice of each
    if args.data_dir:
        ds = FolderDataset(args.data_dir, cfg, align=args.align,
                           assets=assets)
        source = ds.batches(cfg.batch_size, seed=args.seed + 1,
                            shard=mesh.shard_batch)
    else:
        source = synthetic_batches(pipe.bfm, cfg, cfg.batch_size,
                                   seed=args.seed + 1, pool=args.data_pool,
                                   shard=mesh.shard_batch)
    wire_u8 = not args.wire_f32
    data = prefetch(((host_wire(images, wire_u8), lmk, coeff)
                     for images, lmk, coeff in source), depth=2)

    def staged():
        images, lmk, _ = next(data)
        return (stage_images(images, pipe.device),
                torch.as_tensor(lmk, dtype=torch.float32).to(pipe.device))

    # whole chunks only: round the step budget DOWN so --steps is never
    # exceeded
    n_iters = max(1, args.steps // chunk)
    if chunk > 1 and args.steps % chunk and lead:
        print(f"--steps {args.steps} is not a multiple of --chunk {chunk}: "
              f"running {n_iters * chunk} steps")
    # the first iterations build the kernels and pick the convolutions'
    # algorithms: the rate times those after iteration `warm`
    warm = min(3, n_iters - 1)
    first_loss = last_loss = None
    t0 = time.perf_counter()
    try:
        for i in range(n_iters):
            # chunk steps run between two reads of the host
            for images, lmk in [staged() for _ in range(chunk)]:
                parts = train_step(state, images, lmk)
            if i == 0:
                first_loss = float(parts["total"])   # waits for the device
            if i == warm:
                float(parts["total"])
                t0 = time.perf_counter()
            if (i + 1) % args.log_every == 0 or i == n_iters - 1:
                last_loss = float(parts["total"])
                rate = (cfg.batch_size * chunk * (i - warm)
                        / (time.perf_counter() - t0) if i > warm
                        else float("nan"))
                if lead:
                    print(json.dumps({
                        "step": (i + 1) * chunk,
                        **{k: round(float(v), 5) for k, v in parts.items()},
                        "faces_per_sec": round(rate, 1)}))
                if writer is not None:
                    for k, v in parts.items():
                        writer.add_scalar(k, float(v), (i + 1) * chunk)
            if mgr and lead and (i + 1) % cfg.checkpoint_every == 0:
                save_state(mgr, pipe, state)
    finally:
        data.close()
        if writer is not None:
            writer.close()
    if mgr and lead:
        save_state(mgr, pipe, state)
    report = {"steps": args.steps, "first_loss": first_loss,
              "last_loss": last_loss,
              "improved": (first_loss is None or last_loss is None
                           or last_loss < first_loss)}
    if lead:
        print(json.dumps(report))
    return report


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--chunk", type=int, default=1,
                   help="optimizer steps between two reads of the host "
                        "(--steps is rounded down to a multiple)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--data-pool", type=int, default=0,
                   help="synthetic source: render this many batches once "
                        "and epoch over them (0 = a fresh render each "
                        "step)")
    p.add_argument("--data-dir", default=None,
                   help="folder of (image, 68-landmark) pairs; omit for "
                        "the synthetic source")
    p.add_argument("--align", default="68pt",
                   choices=("5pt", "68pt", "none"),
                   help="alignment mode for --data-dir images")
    p.add_argument("--wire-f32", action="store_true",
                   help="send host image batches to the device as float32 "
                        "instead of uint8 (4x the bytes)")
    p.add_argument("--bfm", default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-landmarks", action="store_true")
    p.add_argument("--tensorboard", default=None,
                   help="directory for TensorBoard scalar summaries")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu for the "
                        "plain PyTorch path)")
    return p.parse_args(argv)


def main(argv=None):
    try:
        return run(parse_args(argv))
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
