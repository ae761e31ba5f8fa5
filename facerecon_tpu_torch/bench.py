"""Benchmark entry points (twin of the repository root's bench.py).

Each mode builds the reference's workload, times it on the device and
prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}:

  python -m facerecon_tpu_torch.bench                      # headline
  BENCH_MODE=train python -m facerecon_tpu_torch.bench     # config 4
  BENCH_MODE=render512 python -m facerecon_tpu_torch.bench # config 5
  BENCH_BATCH=2 BENCH_MICROBATCH=2 BENCH_REPS=1 BENCH_INNER_REPS=1 \
      python -m facerecon_tpu_torch.bench --device cpu     # plain path

  - headline: batch 256 in microbatches of 128 through the BatchNorm
    ResNet-50 as the reference initialises it (zero head: every image
    regresses the frontal mean face), folded into the fused model, bf16;
    regress + the inference render (kernel K1) at 224 px; images from
    np.random.default_rng(0);
  - train: one training step (BN model in train mode, differentiable
    render with kernels K2 and K3, losses, backward, Adam) at batch 128,
    `BENCH_CHUNK` eager steps a timed iteration;
  - render512: coefficients -> the inference render at 512 px (focal
    scaled, tile_h 2 x 8 columns), batch 256 in microbatches of 32.

Knobs are the reference's environment variables with its defaults:
BENCH_MODE, BENCH_BATCH, BENCH_MICROBATCH, BENCH_REPS, BENCH_INNER_REPS,
BENCH_CHUNK, BENCH_TILEH, BENCH_COLS, and BENCH_RECORD=<file>, which
appends each printed line there too. `--device` (default cuda) raises
without a card unless it is "cpu". `vs_baseline` is null: the reference
divides by a target set for another chip, which is no target here.

Timing: TF32 off; one warm-up pass (which builds the kernels at their
first launch) outside the timed window; the window is the host clock
between two synchronisations of the device, with no host read inside
it, divided as the reference divides it.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Tuple

import numpy as np
import torch

from facerecon_tpu_torch import resolve_device
from facerecon_tpu_torch.config import default_config
from facerecon_tpu_torch.data.synthetic import sample_coeffs
from facerecon_tpu_torch.ops.geometry import device_bfm
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.pipeline import (Pipeline, fuse_for_inference,
                                          make_train_pipeline)
from facerecon_tpu_torch.train import init_state, make_train_step
from facerecon_tpu_torch.utils.bfm import synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff


def emit(payload: dict) -> None:
    """Print the JSON line; with BENCH_RECORD=<file> also append it
    there."""
    line = json.dumps(payload)
    print(line)
    rec = os.environ.get("BENCH_RECORD")
    if rec:
        with open(rec, "a") as f:
            f.write(line + "\n")


def _payload(what: str, batch: int, seconds: float) -> dict:
    return {"metric": f"faces/sec/chip ({what}, batch-{batch})",
            "value": batch / seconds, "unit": "faces/s",
            "vs_baseline": None}


def _device(device) -> torch.device:
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(one: Callable, n: int, dev: torch.device) -> Tuple[float, object]:
    """Runs `one()` once outside the window (build and warm-up), then n
    times between two synchronisations of `dev`. Returns (seconds a run
    on the host clock, the last run's outputs, still on the device)."""
    out = one()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        out = one()
    _sync(dev)
    return (time.perf_counter() - t0) / n, out


# --- headline: regress + render, 224 px ---

def headline_pipeline(cfg, assets, device="cuda", dtype=torch.bfloat16,
                      seed: int = 0) -> Pipeline:
    """The reference's headline model: the BatchNorm regressor
    initialised from `seed` as the reference's init_params initialises
    it (zero head, running statistics 0 and 1), folded into the fused
    model."""
    return fuse_for_inference(make_train_pipeline(cfg, assets, device=device,
                                                  dtype=dtype, seed=seed))


def headline_images(batch: int, size: int) -> np.ndarray:
    """The reference's images: uniform [0, 1) from default_rng(0)."""
    return np.random.default_rng(0).random(
        (batch, size, size, 3)).astype(np.float32)


def headline_pass(pipe: Pipeline, images: torch.Tensor, micro: int):
    """One pass over the batch in microbatches: each a reconstruct
    through the inference render (K1). Returns (coefficients (B, n_coeff),
    image means over (H, W, 3) (B,)), on the device: the mean depends on
    the shaded image, as the reference's does."""
    coeffs, means = [], []
    for im in images.split(micro):
        cv, _, out = pipe.reconstruct(im, inference=True)
        coeffs.append(cv)
        means.append(out.image.mean(dim=(1, 2, 3)))
    return torch.cat(coeffs), torch.cat(means)


def headline(batch: int = 256, micro: int = 128, reps: int = 10,
             inner_reps: int = 8, device="cuda"):
    """Returns (the JSON payload, the last pass's (coefficients, means))."""
    if batch % micro:
        raise ValueError(f"batch {batch} is not a multiple of the "
                         f"microbatch {micro}")
    dev = _device(device)
    cfg = default_config(batch_size=batch)
    pipe = headline_pipeline(cfg, synthetic_bfm(cfg, seed=0), dev)
    images = torch.from_numpy(headline_images(batch, cfg.image_size)).to(dev)
    # the reference chains inner_reps passes in one dispatch and carries a
    # 1e-30 term from each into the next so that XLA cannot merge them;
    # eager PyTorch runs every pass it is given, so the passes run as they
    # are, reps x inner_reps of them in the window
    dt, out = timed(lambda: headline_pass(pipe, images, micro),
                    reps * inner_reps, dev)
    return _payload("regress+render, 224px", batch, dt), out


# --- train: fwd + bwd + Adam, 224 px ---

def train_inputs(chunk: int, batch: int, size: int):
    """The reference's (chunk, batch, ...) images and landmarks, numpy
    float32, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)
    images = rng.random((chunk, batch, size, size, 3)).astype(np.float32)
    lmk = (rng.random((chunk, batch, 68, 2)) * size).astype(np.float32)
    return images, lmk


def train(batch: int = 128, reps: int = 5, chunk: int = 1, device="cuda"):
    """Returns (the JSON payload, the last step's loss parts)."""
    dev = _device(device)
    cfg = default_config(batch_size=batch)
    pipe = make_train_pipeline(cfg, synthetic_bfm(cfg, seed=0), device=dev)
    state = init_state(pipe, total_steps=1000, seed=0)
    step = make_train_step(pipe)
    images, lmk = (torch.from_numpy(x).to(dev)
                   for x in train_inputs(chunk, batch, cfg.image_size))

    def chunk_of_steps():
        """`chunk` eager steps, one a slice of the chunk axis: the port's
        --chunk (ROADMAP §A)."""
        for k in range(chunk):
            parts = step(state, images[k], lmk[k])
        return parts

    dt, parts = timed(chunk_of_steps, reps, dev)
    return _payload("train fwd+bwd, 224px", batch, dt / chunk), parts


# --- render512: coefficients -> render at 512 px (config 5) ---

@torch.no_grad()
def render512_pass(cfg, bfm, coeffs: torch.Tensor, micro: int):
    """The inference render (K1) of each microbatch of coefficients;
    returns each image's mean over (H, W, 3), (B,), on the device."""
    return torch.cat([render_coeffs(split_coeff(c, cfg), bfm, cfg,
                                    inference=True).image.mean(dim=(1, 2, 3))
                      for c in coeffs.split(micro)])


def render512(batch: int = 256, micro: int = 32, reps: int = 5,
              tile_h: int = 2, cols: int = 8, device="cuda"):
    """Returns (the JSON payload, the last pass's image means)."""
    if batch % micro:
        raise ValueError(f"batch {batch} is not a multiple of the "
                         f"microbatch {micro}")
    dev = _device(device)
    size = 512
    cfg = default_config(image_size=size, focal=1015.0 * size / 224.0,
                         tile_h=tile_h, batch_size=batch, raster_cols=cols)
    bfm = device_bfm(synthetic_bfm(cfg, seed=0), dev)
    coeffs = torch.as_tensor(sample_coeffs(np.random.default_rng(0), cfg,
                                           batch), device=dev)
    dt, means = timed(lambda: render512_pass(cfg, bfm, coeffs, micro), reps,
                      dev)
    return _payload("render-only, 512px", batch, dt), means


def _knobs(**env) -> dict:
    """keyword -> int of each named environment knob that is set; the
    modes' own defaults are the reference's."""
    return {k: int(os.environ[v]) for k, v in env.items() if v in os.environ}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for the plain PyTorch "
                        "path)")
    device = p.parse_args(argv).device
    mode = os.environ.get("BENCH_MODE")
    if mode == "render512":
        payload, _ = render512(device=device, **_knobs(
            batch="BENCH_BATCH", micro="BENCH_MICROBATCH", reps="BENCH_REPS",
            tile_h="BENCH_TILEH", cols="BENCH_COLS"))
    elif mode == "train":
        payload, _ = train(device=device, **_knobs(
            batch="BENCH_BATCH", reps="BENCH_REPS", chunk="BENCH_CHUNK"))
    else:
        payload, _ = headline(device=device, **_knobs(
            batch="BENCH_BATCH", micro="BENCH_MICROBATCH", reps="BENCH_REPS",
            inner_reps="BENCH_INNER_REPS"))
    emit(payload)
    return payload


if __name__ == "__main__":
    main()
