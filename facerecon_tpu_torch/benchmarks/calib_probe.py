"""Calibrates the chained timer (twin of benchmarks/calib_probe.py): each
case runs its op K times a call on k-perturbed inputs, so the slope
(t(K=4) - t(K=1)) / 3 is the op's own cost and t(K=1) less the slope is
the harness's fixed cost a call (here: the perturbation pass, the
chain's small ops and the host launches).

  python -m facerecon_tpu_torch.benchmarks.calib_probe
  BATCH=2 python -m facerecon_tpu_torch.benchmarks.calib_probe --device cpu

env: BATCH (128). The data is made on the device from a seeded
torch.Generator: x64 (B,56,56,64) bf16 and pvr (B,70657) f32 uniform,
bidx (B,50176) int64 in [0, 70656) (torch.gather takes int64 indices).
`--device` (default cuda) raises without a card unless it is "cpu".
"""

from __future__ import annotations

import argparse
import functools
import os

import torch

from facerecon_tpu_torch.bench import _device
from facerecon_tpu_torch.benchmarks import _timing

INNER, REPS = 16, 3
LINE = "{tag:32s}: {ms:7.3f} ms  [compile {ct:.0f}s]"


def knobs() -> dict:
    return dict(batch=int(os.environ.get("BATCH", "128")))


def make_inputs(batch: int, device):
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x64 = torch.rand((batch, 56, 56, 64), generator=g, device=dev,
                     dtype=torch.bfloat16)
    pvr = torch.rand((batch, 70657), generator=g, device=dev)
    bidx = torch.randint(0, 70656, (batch, 50176), generator=g, device=dev)
    return x64, pvr, bidx


def relu_k(k: int):
    """K relus of x, each on x * (1 + i * 1e-30): the sum of their f32
    sums (benchmarks/calib_probe.py:58-62)."""
    def f(x):
        return sum(torch.relu(x * (1.0 + i * 1e-30)).float().sum()
                   for i in range(k))
    return f


def talax_k(k: int):
    """K per-image gathers along axis 1 (take_along_axis), each of x * (1
    + i * 1e-30): the sum of their sums (:64-68)."""
    def f(x, idx):
        return sum(torch.gather(x * (1.0 + i * 1e-30), 1, idx).sum()
                   for i in range(k))
    return f


def _slope(tag, t1, t4):
    print(f"  -> {tag} true {1000*(t4-t1)/3:.3f} ms, "
          f"overhead {1000*(t1-(t4-t1)/3):.3f} ms", flush=True)


def run(x64, pvr, bidx):
    """The reference's four cases and their slopes; returns the Cases."""
    cases = []
    timed = functools.partial(_timing.timed, inner=INNER, reps=REPS,
                              line=LINE, cases=cases)
    t1 = timed("relu64 K=1", relu_k(1), x64)
    t4 = timed("relu64 K=4", relu_k(4), x64)
    _slope("relu64", t1, t4)
    g1 = timed("talax K=1", talax_k(1), pvr, bidx)
    g4 = timed("talax K=4", talax_k(4), pvr, bidx)
    _slope("talax", g1, g4)
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(*make_inputs(knobs()["batch"], args.device))


if __name__ == "__main__":
    main()
