"""Scatter-min, element-gather and sort rates at the rasterizer's sizes
(twin of benchmarks/scatter_probe.py): the cost of a rasterizer that
scatters one (pixel, depth key) record a triangle and keeps each pixel's
minimum, the classic GPU design, in two exact passes:
  pass 1: zmin[p] = min over the candidates at p of their depth bits;
  gather: each candidate reads zmin at its pixel;
  pass 2: idw[p] = min over the candidates at p whose bits equal zmin of
          their id.

  python -m facerecon_tpu_torch.benchmarks.scatter_probe   # BATCH=128 M=43008
  BATCH=2 M=256 python -m facerecon_tpu_torch.benchmarks.scatter_probe --device cpu

env: BATCH (128), M (43008 candidates an image), SIZE (224 px). Data from
np.random.default_rng(0) in the reference's draw order: pixels clustered
as r^2 * hw, depth bits in [2^20, 2^30) and ids below 2^20. The reference
keeps them in uint32, which PyTorch scatters, indexes and sorts little;
both ranges fit int32 with the same order, so they are int32 here with
INT32_MAX for the 0xFFFFFFFF sentinel (scatter and gather indices are
int64, the only ones PyTorch takes there). The reference scatters with
mode="drop"; its pixels are clipped to hw - 1, so none is dropped and
none is here. The timer passes its carry in as `seed` (not as a
perturbed input), as the reference's does. `--device` (default cuda)
raises without a card unless it is "cpu".
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch

from facerecon_tpu_torch.bench import _device
from facerecon_tpu_torch.benchmarks import _timing

INNER, REPS = 8, 3
INT32_MAX = 2**31 - 1


def knobs() -> dict:
    env = os.environ.get
    return dict(batch=int(env("BATCH", "128")), m=int(env("M", "43008")),
                size=int(env("SIZE", "224")))


def make_inputs(batch: int, m: int, size: int, device):
    """(idx (B,M) pixels in [0, hw), zb (B,M) depth bits, ids (B,M)),
    int32 on the device."""
    dev = _device(device)
    hw = size * size
    rng = np.random.default_rng(0)
    idx = np.minimum((rng.random((batch, m)) ** 2 * hw), hw - 1).astype(
        np.int32)
    zb = rng.integers(1 << 20, 1 << 30, (batch, m), dtype=np.int64)
    ids = rng.integers(0, 1 << 20, (batch, m), dtype=np.int64)
    return tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                 for a in (idx, zb, ids))


def scatter_min(gi, vals, n: int):
    """out[p] = min(INT32_MAX, vals[j] for gi[j] == p), (n,) int32."""
    out = torch.full((n,), INT32_MAX, dtype=torch.int32, device=vals.device)
    return out.scatter_reduce_(0, gi, vals, "amin")


def two_pass(gi, zf, idf, n: int):
    """(zmin, idw): pass 1, the element gather, pass 2 (:76-86)."""
    zmin = scatter_min(gi, zf, n)
    idw = torch.where(zmin[gi] == zf, idf, INT32_MAX)
    return zmin, scatter_min(gi, idw, n)


def flat_index(idx, hw: int, seed):
    """Each image's pixels offset by image * hw, plus int(seed * 1e-30),
    flattened (int64)."""
    boff = torch.arange(idx.shape[0], device=idx.device)[:, None] * hw
    return (idx + boff + (seed * 1e-30).to(torch.int32)).reshape(-1)


def make_cases(hw: int):
    """The reference's four cases (:70-98): tag -> fn(idx, zb, ids,
    seed) -> an f32 scalar."""
    def scat1(idx, zb, ids, seed):
        gi = flat_index(idx, hw, seed)
        return scatter_min(gi, zb.reshape(-1),
                           idx.shape[0] * hw)[0].float()

    def scat2(idx, zb, ids, seed):
        gi = flat_index(idx, hw, seed)
        zmin, idw = two_pass(gi, zb.reshape(-1), ids.reshape(-1),
                             idx.shape[0] * hw)
        return zmin[0].float() + idw[1].float()

    def gath(idx, zb, ids, seed):
        gi = flat_index(idx, hw, seed)
        src = torch.zeros((idx.shape[0] * hw,), dtype=torch.int32,
                          device=idx.device) + zb[0, 0]
        return src[gi].sum().float()

    def segsort(idx, zb, ids, seed):
        # a proxy of a per-image key sort: the int32 pixel keys alone
        k = idx + (seed * 1e-30).to(torch.int32)
        return torch.sort(k, dim=1).values[0, 0].float()

    return [("scatter-min u32 1-pass", scat1),
            ("scatter-min 2-pass+gather", scat2),
            ("element gather", gath), ("sort (proxy)", segsort)]


def run(idx, zb, ids, size: int, batch: int):
    """The four cases; returns the Cases."""
    cases = []
    timed = functools.partial(
        _timing.timed, inner=INNER, reps=REPS, cases=cases, seeded=True,
        first_line="{tag}: compile {ct:.0f}s",
        line="{tag}: {ms:7.2f} ms/" + str(batch))
    for tag, fn in make_cases(size * size):
        timed(tag, fn, idx, zb, ids)
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    k = knobs()
    return run(*make_inputs(k["batch"], k["m"], k["size"], args.device),
               k["size"], k["batch"])


if __name__ == "__main__":
    main()
