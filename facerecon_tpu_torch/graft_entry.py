"""Driver entry points (twin of the repository root's __graft_entry__.py).

entry() returns (fn, args): the flagship forward at 224 px, batch 8 of
zero images, through the BatchNorm ResNet-50 as the reference
initialises it (eval mode) and the differentiable render (kernel K2 on
the card). fn(*args) -> (coefficients, image, 2-D landmarks).

  >>> from facerecon_tpu_torch.graft_entry import entry
  >>> fn, args = entry(device="cpu")
  >>> coeffs, image, lmk = fn(*args)

reconstruct_fn() builds that model and forward; the trace endpoint
(profile_trace.py) traces the same forward.

dryrun_multichip(n) starts n processes, one a device, joins them in one
process group (nccl on cuda, gloo on the CPU) and runs ONE data-parallel
training step of tiny_config(batch_size=2n) with landmarks: the global
batch sharded over the ranks, the model replicated from rank 0, the
gradients and BatchNorm's moments all-reduced (parallel/mesh.py). It
checks that the loss is finite and prints the reference's line.

  >>> from facerecon_tpu_torch.graft_entry import dryrun_multichip
  >>> dryrun_multichip(2, device="cpu")
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch


def reconstruct_fn(cfg=None, assets=None, device="cuda",
                   dtype=torch.bfloat16):
    """(fn, pipe): the reference's make_pipeline + init_params(PRNGKey(0))
    + make_reconstruct_fn(pipe). pipe holds the BatchNorm model (`dtype`,
    bf16 as the reference's) initialised from seed 0 (zero head) in eval
    mode and cfg's assets (default_config() and synthetic_bfm(cfg, 0)
    when None). fn(model, bfm, images) -> (coefficients, RenderOut)
    renders with inference=False, the default of the reference's
    make_reconstruct_fn, and keeps the autograd graph."""
    from facerecon_tpu_torch.config import default_config
    from facerecon_tpu_torch.ops.render import render_coeffs
    from facerecon_tpu_torch.pipeline import make_train_pipeline
    from facerecon_tpu_torch.utils.bfm import synthetic_bfm
    from facerecon_tpu_torch.utils.coeffs import split_coeff

    cfg = default_config() if cfg is None else cfg
    if assets is None:
        assets = synthetic_bfm(cfg, seed=0)
    pipe = make_train_pipeline(cfg, assets, device=device, dtype=dtype,
                               seed=0)
    pipe.model.eval()

    def fn(model, bfm, images):
        coeff_vec = model(images)
        return coeff_vec, render_coeffs(split_coeff(coeff_vec, cfg), bfm,
                                        cfg, background=images)

    return fn, pipe


def entry(device="cuda"):
    """(fn, (model, bfm, images)) as the reference's entry() builds them:
    reconstruct_fn's model and assets at default_config(), and zeros
    (8, 224, 224, 3). fn(*args) -> (coefficients, image, 2-D landmarks),
    differentiable."""
    forward, pipe = reconstruct_fn(device=device)
    s = pipe.cfg.image_size
    images = torch.zeros((8, s, s, 3), device=pipe.device)

    def fn(model, bfm, images):
        coeff_vec, out = forward(model, bfm, images)
        return coeff_vec, out.image, out.geometry.landmarks2d

    return fn, (pipe.model, pipe.bfm, images)


def _dryrun_rank(rank: int, n: int, device: str, init_file: str,
                 results) -> None:
    """One rank of the dry run; rank 0 puts the global loss on
    `results`."""
    from facerecon_tpu_torch.config import tiny_config
    from facerecon_tpu_torch.parallel import mesh
    from facerecon_tpu_torch.pipeline import make_train_pipeline
    from facerecon_tpu_torch.train import init_state, make_train_step
    from facerecon_tpu_torch.utils.bfm import synthetic_bfm

    torch.set_num_threads(2)
    dev = mesh.init(device, world_size=n, rank=rank,
                    init_method=f"file://{init_file}")
    try:
        cfg = tiny_config(batch_size=2 * n)
        pipe = make_train_pipeline(cfg, synthetic_bfm(cfg, seed=0),
                                   device=dev)
        state = init_state(pipe, 10, seed=0)
        mesh.replicate(pipe.model)
        step = make_train_step(pipe, use_landmarks=True)
        b = cfg.batch_size
        rng = np.random.default_rng(0)
        images = rng.random((b, cfg.image_size, cfg.image_size, 3)).astype(
            np.float32)
        lmk = (rng.random((b, cfg.n_landmarks, 2)) * cfg.image_size).astype(
            np.float32)
        images, lmk = (torch.from_numpy(x).to(dev)
                       for x in mesh.shard_batch((images, lmk)))
        total = float(step(state, images, lmk)["total"])
        if rank == 0:
            results.put(total)
    finally:
        mesh.close()


_JOIN_S = 600.0    # a rank still running after this long has hung


def spawn(fn, args: tuple, n: int) -> None:
    """fn(rank, *args) in n spawned processes; waits for every one, at
    most _JOIN_S seconds: a rank that hangs (a rendezvous that never
    completes) is killed and the call raises. A rank that fails raises
    here too."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(fn, args=args, nprocs=n, join=False)
    deadline = time.monotonic() + _JOIN_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{n} ranks of {fn.__name__} still running "
                               f"after {_JOIN_S} s")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> float:
    """One sharded train step over n_devices processes. On cuda it needs
    n_devices cards (one a rank) and raises otherwise; "cpu" runs the
    ranks on the host over gloo. Returns the global loss."""
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if n_devices > have:
            raise RuntimeError(f"dryrun_multichip({n_devices}): needs "
                               f"{n_devices} CUDA devices, have {have}")
    tmp = tempfile.mkdtemp()
    try:
        results = mp.get_context("spawn").SimpleQueue()
        spawn(_dryrun_rank, (n_devices, device,
                             os.path.join(tmp, "rendezvous"), results),
              n_devices)
        total = results.get()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not np.isfinite(total):
        raise AssertionError(f"non-finite loss {total}")
    print(f"dryrun_multichip({n_devices}): one sharded train step OK, "
          f"loss={total:.4f}")
    return total
