"""Render-chain benchmark (twin of benchmarks/render_bench.py): geometry,
binning, the select (kernel K2), shading and, with --bwd, the losses and
their gradient to the coefficients (kernel K3), without the CNN.

  python -m facerecon_tpu_torch.render_bench [--batch 64] [--size 224] [--bwd]
  python -m facerecon_tpu_torch.render_bench --batch 1 --reps 1 --inner 1 \
      --size 112 --device cpu                          # plain path

default_config at --size (focal scaled as 1015 * size / 224, tile_h 2 at
256 px or less, else 1; raster_cols stays 7), synthetic_bfm(cfg, 0),
coefficients from sample_coeffs(np.random.default_rng(0)) and a zero
target. One call: fwd, the mean of the differentiable render's image
under no_grad (one K2 launch); --bwd, the loss (total_loss, no
landmarks, the target as background) plus the mean of its gradient to
the coefficients (one K2 and one K3 launch).

A chain is `--inner` calls in a row, each fed cv * (1 + carry * 1e-30)
with carry the previous call's scalar * 1e-30, kept on the device, so
each call waits on the one before; it returns the sum of the calls'
scalars. One chain runs first (it builds the kernels at their first
launch), then `--reps` and 2 * `--reps` chains, each run ended by one
host read of its last chain's sum, and each printed as ms a batch and
faces/s. TF32 off; no CUDA graph, no torch.compile. `--device` (default
cuda) raises without a card unless it is "cpu".
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from facerecon_tpu_torch.bench import _device
from facerecon_tpu_torch.benchmarks import _timing
from facerecon_tpu_torch.config import default_config
from facerecon_tpu_torch.data.synthetic import sample_coeffs
from facerecon_tpu_torch.ops.geometry import device_bfm
from facerecon_tpu_torch.ops.losses import total_loss
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.utils.bfm import synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff


def default_tile_h(size: int) -> int:
    """The reference's --tileh default: 2 at 256 px or less, else 1."""
    return 2 if size <= 256 else 1


def setup(size: int = 224, batch: int = 64, tile_h=None, device="cuda",
          cfg=None, assets=None):
    """(cfg, bfm, coefficients (B, n_coeff), zero target (B, S, S, 3)) as
    the reference builds them. `cfg`, when given, takes default_config's
    place (image_size, focal and tile_h are set on it all the same), and
    `assets` synthetic_bfm's."""
    dev = _device(device)
    if tile_h is None:
        tile_h = default_tile_h(size)
    over = dict(image_size=size, focal=1015.0 * size / 224.0, tile_h=tile_h)
    cfg = (default_config(**over) if cfg is None
           else dataclasses.replace(cfg, **over))
    if assets is None:
        assets = synthetic_bfm(cfg, seed=0)
    bfm = device_bfm(assets, dev)
    coeffs = torch.as_tensor(sample_coeffs(np.random.default_rng(0), cfg,
                                           batch), device=dev)
    target = torch.zeros((batch, size, size, 3), device=dev)
    return cfg, bfm, coeffs, target


def value_and_grad(cfg, bfm, target, cv):
    """(loss, its gradient to cv): total_loss of the differentiable render
    over the target as background, with no landmarks. The gradient is
    taken to a leaf made from cv, as jax.value_and_grad takes it to cv;
    the leaf keeps cv's value, so work on it waits on whatever made cv."""
    c = cv.detach().requires_grad_()
    with torch.enable_grad():
        coeffs = split_coeff(c, cfg)
        out = render_coeffs(coeffs, bfm, cfg, background=target)
        loss = total_loss(out, coeffs, target, None, bfm, cfg)[0]
        grad, = torch.autograd.grad(loss, c)
    return loss.detach(), grad


def make_one(cfg, bfm, target, bwd: bool) -> Callable:
    """The reference's fwd_one or, with bwd, bwd_one: coefficients (B,
    n_coeff) -> a scalar on their device."""

    @torch.no_grad()
    def fwd_one(cv):
        return render_coeffs(split_coeff(cv, cfg), bfm, cfg).image.mean()

    def bwd_one(cv):
        loss, grad = value_and_grad(cfg, bfm, target, cv)
        return loss + grad.mean()

    return bwd_one if bwd else fwd_one


def chain(one: Callable, cv: torch.Tensor, inner: int) -> torch.Tensor:
    """`inner` calls of one() in a row, each on cv * (1 + carry * 1e-30)
    with carry the previous call's scalar * 1e-30: the sum of their
    scalars, with no host read."""
    return _timing.chain(one, (cv,), inner)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--inner", type=int, default=8,
                    help="chained calls a chain")
    ap.add_argument("--tileh", type=int, default=None)
    ap.add_argument("--bwd", action="store_true",
                    help="measure forward+backward (grad wrt coeffs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain PyTorch "
                         "path)")
    return ap.parse_args(argv)


def run(one: Callable, cv: torch.Tensor, reps: int, inner: int,
        tag: str) -> dict:
    """The reference's timing of chains of one() on cv, with its lines
    printed. Returns {"first_sum": the first chain's sum, "runs": [(reps,
    ms a batch, faces/s)], "sum": the last chain's sum}."""
    batch = cv.shape[0]
    t0 = time.time()
    first_sum = float(chain(one, cv, inner))
    print(f"compile+first: {time.time()-t0:.1f}s", flush=True)
    runs = []
    for n in (reps, 2 * reps):
        t0 = time.time()
        for _ in range(n):
            out = chain(one, cv, inner)
        last = float(out)
        dt = (time.time() - t0) / (n * inner)
        print(f"{tag} chain reps={n}: {dt*1000:.1f} ms/{batch} -> "
              f"{batch/dt:.0f} faces/s", flush=True)
        runs.append((n, dt * 1e3, batch / dt))
    return {"first_sum": first_sum, "runs": runs, "sum": last}


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg, bfm, coeffs, target = setup(args.size, args.batch, args.tileh,
                                     args.device)
    return run(make_one(cfg, bfm, target, args.bwd), coeffs, args.reps,
               args.inner, "fwd+bwd" if args.bwd else "fwd")


if __name__ == "__main__":
    main()
