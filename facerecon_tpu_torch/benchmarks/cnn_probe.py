"""Per-stage time of the fused serving CNN (twin of
benchmarks/cnn_probe.py) by chained truncation: cut k runs the network
up to its cut point, so a stage's cost is the delta between consecutive
cuts.

  python -m facerecon_tpu_torch.benchmarks.cnn_probe     # BATCH=64 bf16
  BATCH=1 INNER=1 REPS=1 DTYPE=float32 \
      python -m facerecon_tpu_torch.benchmarks.cnn_probe --device cpu

env: BATCH (64), REPS (3), INNER (8), DTYPE (bfloat16 | float32),
WDTYPE (unset). The reference documents all five and reads BATCH and
WDTYPE; its REPS, INNER and DTYPE are fixed at these defaults.

The model is the reference's: the BatchNorm ResNet-50 as its
init_params initialises it, folded by fuse_for_inference
(bench.headline_pipeline). Images (B, 224, 224, 3) come from
np.random.default_rng(0). A cut is a FusedResNetRegressor with shortened
stage_sizes holding the state of the stem and of the first n blocks and a
head stub: a zero weight of the cut's width and the full head's bias
(the reference's _prefix_params and _head_stub). So a cut's output is the
head's bias whatever the backbone computes; in eager mode the backbone
runs all the same, which the deltas show. WDTYPE rounds every float32
parameter through that dtype (the reference casts them): the port's
modules compute in their weights' dtype, so at DTYPE=bfloat16 the convs
already hold bf16 weights and only the float32 head is rounded.
`--device` (default cuda) raises without a card unless it is "cpu".
"""

from __future__ import annotations

import argparse
import functools
import os
from collections import OrderedDict

import numpy as np
import torch

from facerecon_tpu_torch.bench import _device, headline_pipeline
from facerecon_tpu_torch.benchmarks import _timing
from facerecon_tpu_torch.config import default_config
from facerecon_tpu_torch.models.fused import FusedResNetRegressor
from facerecon_tpu_torch.utils.bfm import synthetic_bfm

LINE = "{tag:24s}: {ms:7.2f} ms/{b}  [compile {ct:.0f}s]"
# cut points (benchmarks/cnn_probe.py:72-76): blocks kept in each stage
CUTS = [("stem+pool", (0, 0, 0, 0)),
        ("+stage1 (3 blk)", (3, 0, 0, 0)),
        ("+stage2 (4 blk)", (3, 4, 0, 0)),
        ("+stage3 (6 blk)", (3, 4, 6, 0)),
        ("full  (+stage4+head)", None)]


def knobs() -> dict:
    env = os.environ.get
    return dict(batch=int(env("BATCH", "64")), reps=int(env("REPS", "3")),
                inner=int(env("INNER", "8")),
                dtype=getattr(torch, env("DTYPE", "bfloat16")),
                wdtype=env("WDTYPE"))


def head_stub(sd, n_blocks: int):
    """(weight, bias) of the cut's head (:111-122): zeros of the width
    after n_blocks (the stem's, or the last kept block's output) and the
    full head's bias."""
    if n_blocks == 0:
        width = sd["stem.weight"].shape[0]
    else:
        width = sd[f"blocks.{n_blocks - 1}.conv2.weight"].shape[0]
    bias = sd["head.bias"]
    return bias.new_zeros((bias.shape[0], width)), bias


def prefix_state(sd, n_blocks: int) -> "OrderedDict[str, torch.Tensor]":
    """The full model's state_dict cut after n_blocks (:103-108): the
    stem, blocks 0..n_blocks-1 and the head stub."""
    keep = ("stem.",) + tuple(f"blocks.{i}." for i in range(n_blocks))
    out = OrderedDict((k, v) for k, v in sd.items() if k.startswith(keep))
    out["head.weight"], out["head.bias"] = head_stub(sd, n_blocks)
    return out


def cut_model(model: FusedResNetRegressor, stages):
    """The model truncated to `stages` (blocks kept in each stage), on the
    model's device and dtype; None gives the model itself."""
    if stages is None:
        return model
    cut = FusedResNetRegressor(model.head.out_features, stages,
                               dtype=model.dtype)
    cut.load_state_dict(prefix_state(model.state_dict(), sum(stages)))
    dev = model.head.weight.device
    return cut.to(dev, memory_format=torch.channels_last).eval()


def model_and_images(batch: int, device, dtype=torch.bfloat16,
                     wdtype=None):
    """The reference's folded model (with WDTYPE's rounding) and images,
    on the device."""
    dev = _device(device)
    cfg = default_config(batch_size=batch)
    model = headline_pipeline(cfg, synthetic_bfm(cfg, seed=0), dev,
                              dtype=dtype).model
    if wdtype:
        with torch.no_grad():
            for p in model.parameters():
                if p.dtype == torch.float32:
                    p.copy_(p.to(getattr(torch, wdtype)))
    images = torch.as_tensor(np.random.default_rng(0).random(
        (batch, 224, 224, 3)), dtype=torch.float32, device=dev)
    return model, images


def run(model, images, inner: int = 8, reps: int = 3):
    """Each cut timed on the images, with its delta from the cut before;
    returns the Cases."""
    cases = []
    timed = functools.partial(_timing.timed, inner=inner, reps=reps,
                              line=LINE, cases=cases)
    prev = 0.0
    for tag, stages in CUTS:
        m = cut_model(model, stages)
        dt = timed(tag, lambda im, m=m: m(im).float().sum(), images)
        print(f"    delta {1000*(dt - prev):7.2f} ms", flush=True)
        prev = dt
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    k = knobs()
    model, images = model_and_images(k["batch"], args.device, k["dtype"],
                                     k["wdtype"])
    return run(model, images, k["inner"], k["reps"])


if __name__ == "__main__":
    main()
