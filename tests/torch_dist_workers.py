"""Rank functions for tests/test_torch_parallel.py.

torch.multiprocessing spawns one process a rank, which re-imports the
module that holds its function: this one imports torch and the port
only (no JAX, nothing of tests/conftest.py), so a rank costs a torch
import. Each function runs inside a gloo group made by `run_ranks`, or
with no group at all when a test calls it directly (the single-process
result), and returns numpy arrays.
"""

from __future__ import annotations

import os
import pickle
import types
import unittest.mock

import numpy as np
import torch

from facerecon_tpu_torch.graft_entry import spawn
from facerecon_tpu_torch.parallel import mesh


def _rank_main(rank, n, tmp_dir, fn, args):
    torch.set_num_threads(2)
    mesh.init("cpu", world_size=n, rank=rank,
              init_method=f"file://{os.path.join(tmp_dir, 'rendezvous')}")
    try:
        out = fn(*args)
    finally:
        mesh.close()
    with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def run_ranks(fn, n: int, tmp_dir, *args) -> list:
    """fn(*args) on n ranks of a gloo group (rendezvous through a file
    under tmp_dir, so concurrent tests never share a port). Returns the
    ranks' results in rank order (each written to a file under tmp_dir:
    a pipe would block a rank whose result outgrows its buffer). A rank
    that hangs is killed and the call raises (graft_entry.spawn)."""
    tmp_dir = str(tmp_dir)
    spawn(_rank_main, (n, tmp_dir, fn, args), n)
    out = []
    for r in range(n):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().copy()


def train_steps(sync_bn: bool = True):
    """One data-parallel train step of the float32 depth-18 model at
    tiny_config() on one rendered global batch of 8, this rank's slice of
    it. The head is drawn small and non-zero (std 0.01, seeded), so the
    gradient reaches the stem. sync_bn=False patches BatchNorm's view of
    the world to one rank, which turns its all-reduce of the moments
    off. Returns the loss, the parameters, the gradients and the running
    statistics."""
    from facerecon_tpu_torch.config import tiny_config
    from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
    from facerecon_tpu_torch.models import resnet
    from facerecon_tpu_torch.pipeline import make_train_pipeline
    from facerecon_tpu_torch.train import init_state, make_train_step
    from facerecon_tpu_torch.utils.bfm import synthetic_bfm

    cfg = tiny_config()
    pipe = make_train_pipeline(cfg, synthetic_bfm(cfg, 0), device="cpu",
                               dtype=torch.float32, depth=18)
    state = init_state(pipe, 10, seed=0)
    with torch.no_grad():
        pipe.model.head.weight.copy_(0.01 * torch.randn(
            pipe.model.head.weight.shape,
            generator=torch.Generator().manual_seed(1)))
    mesh.replicate(pipe.model)
    gt = sample_coeffs(np.random.default_rng(1), cfg, 8)
    images, lmk = mesh.shard_batch(render_batch(gt, pipe.bfm, cfg))
    world = mesh if sync_bn else types.SimpleNamespace(world=lambda: 1)
    with unittest.mock.patch.object(resnet, "mesh", world):
        loss = float(make_train_step(pipe)(state, images, lmk)["total"])
    return {"loss": loss,
            "params": {k: _np(p) for k, p in pipe.model.named_parameters()},
            "grads": {k: _np(p.grad)
                      for k, p in pipe.model.named_parameters()},
            "stats": {k: _np(b) for k, b in pipe.model.named_buffers()}}


def _sequence(frames: int = 8):
    """tests/test_sharding.py:92's sequence at tiny_config(): one face,
    the yaw swept over `frames` frames, and its rendered frames."""
    from facerecon_tpu_torch.config import tiny_config
    from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
    from facerecon_tpu_torch.utils.bfm import synthetic_bfm
    cfg = tiny_config()
    bfm = device_bfm(synthetic_bfm(cfg, 0), "cpu")
    base = sample_coeffs(np.random.default_rng(2), cfg, 1)[0]
    seq = np.tile(base, (frames, 1))
    seq[:, cfg.coeff_split[2]] += np.linspace(-0.1, 0.1, frames).astype(
        np.float32)
    frames, lmk = render_batch(seq, bfm, cfg)
    return cfg, bfm, seq, frames, lmk


def joint_solve(steps: int = 10, lr: float = 1e-2):
    """track.make_refine_fn on 8 frames from seq * 0.5, the frames
    sharded over the ranks when there is a group (the per-frame leaf
    gathered back after). Returns the losses and the three leaves."""
    from facerecon_tpu_torch import track
    cfg, bfm, seq, frames, lmk = _sequence()
    tp0 = track._decompose(torch.from_numpy(seq * 0.5), cfg)
    sharded = mesh.world() > 1
    if sharded:
        frames, lmk, per_frame = mesh.shard_batch(
            (frames, lmk, tp0.per_frame))
        tp0 = tp0._replace(per_frame=per_frame)
    tp, losses = track.make_refine_fn(cfg, steps, lr, sharded=sharded)(
        tp0, bfm, frames, lmk)
    tp = tp._replace(per_frame=mesh.unshard_batch(tp.per_frame))
    return {"losses": _np(losses),
            **{k: _np(getattr(tp, k)) for k in tp._fields}}


def drivers(tmp_dir):
    """track.run (4 synthetic frames, 10 refine steps) and train.run
    (--batch 4 --chunk 2 --steps 2 with a checkpoint directory) as
    their command lines give them: their reports, and the checkpoint
    steps written."""
    from facerecon_tpu_torch import track, train
    from facerecon_tpu_torch.checkpoint import CheckpointManager
    rep = track.run(track.parse_args(["--tiny", "--device", "cpu",
                                      "--frames", "4", "--refine-steps",
                                      "10"]))
    ck = os.path.join(str(tmp_dir), f"ck_{mesh.world()}")
    train_rep = train.run(train.parse_args([
        "--tiny", "--device", "cpu", "--batch", "4", "--chunk", "2",
        "--steps", "2", "--log-every", "1", "--ckpt-dir", ck]))
    if mesh.grouped():
        torch.distributed.barrier()     # rank 0's save is done
    return {"track": rep, "train": train_rep,
            "saved": CheckpointManager(ck).steps()}


def render(image_size: int, seed: int, batch: int = 8):
    """render_batch of sample_coeffs(default_rng(seed)) at
    tiny_config(image_size) (tile_h 1 above 64 px, as
    tests/test_sharding.py:42 sets it), each rank rendering its slice of
    the batch, gathered back. Returns images and landmarks."""
    from facerecon_tpu_torch.config import tiny_config
    from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
    from facerecon_tpu_torch.utils.bfm import synthetic_bfm
    cfg = tiny_config() if image_size == 64 else tiny_config(
        image_size=image_size, focal=1015.0 * image_size / 224.0, tile_h=1)
    bfm = device_bfm(synthetic_bfm(cfg, 0), "cpu")
    coeff = mesh.shard_batch(sample_coeffs(np.random.default_rng(seed), cfg,
                                           batch))
    images, lmk = render_batch(coeff, bfm, cfg)
    return {"images": _np(mesh.unshard_batch(images)),
            "lmk": _np(mesh.unshard_batch(lmk))}
