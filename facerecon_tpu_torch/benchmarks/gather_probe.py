"""Gather forms of the render-record producer (twin of
benchmarks/gather_probe.py): the mesh-indirection gathers of the corner
records (B,3F,C) and of the normals adjacency, and the per-image gathers
of the select-by-gather design, at the full mesh's sizes (N 35,709
vertices, 3F = 3 x 70,789 corners, 50,176 px, 70,657 rows, degree 6).

  python -m facerecon_tpu_torch.benchmarks.gather_probe          # BATCH=128
  BATCH=2 python -m facerecon_tpu_torch.benchmarks.gather_probe --device cpu

env: BATCH (128). Data from np.random.default_rng(0) in the reference's
draw order. jnp.take becomes index_select (int32 indices, as the
reference's), take_along_axis torch.gather (int64 indices: it takes no
others; the (B,1,px) index of the 16-plane case expanded over the planes,
where take_along_axis broadcasts it). Each form returns the tensors the
reference sums, so a caller can compare them. `--device` (default cuda)
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
LINE = "{tag:34s}: {ms:7.2f} ms  [compile {ct:.0f}s]"
N, F3, PX, ROWS, DEG, N_FACES = 35709, 3 * 70789, 50176, 70657, 6, 70789


def rows(x, idx):
    """jnp.take(x, idx, axis=1) (:55-58, :61-62)."""
    return (x.index_select(1, idx),)


def lanes(x, idx):
    """jnp.take(x, idx, axis=2) (:59-60)."""
    return (x.index_select(2, idx),)


def lanes6(x, idx):
    """Six takes of x * (1 + k * 1e-30) along axis 1 (:63-65)."""
    return tuple((x * (1.0 + k * 1e-30)).index_select(1, idx)
                 for k in range(6))


def talax(x, bidx):
    """take_along_axis(x, bidx, axis=1) (:75-76)."""
    return (torch.gather(x, 1, bidx),)


def talax16(x, bidx):
    """Sixteen per-image gathers of x * (1 + k * 1e-30) (:77-79)."""
    return tuple(torch.gather(x * (1.0 + k * 1e-30), 1, bidx)
                 for k in range(16))


def talax_planes(x, bidx):
    """take_along_axis(x, bidx[:, None, :], axis=2) on (B,16,rows)
    (:80-81)."""
    return (torch.gather(x, 2, bidx[:, None, :].expand(-1, x.shape[1], -1)),)


def adj_rows(x, adj):
    """One take of every adjacency row, then the sum over the degree
    (:89-91)."""
    b, n, deg = x.shape[0], adj.shape[0], adj.shape[1]
    return (x.index_select(1, adj.reshape(-1)).reshape(b, n, deg, 3).sum(2),)


def adj_per_k(x, adj):
    """A take for each k of x * (1 + k * 1e-30), summed (:92-94)."""
    return (sum((x * (1.0 + k * 1e-30)).index_select(1, adj[:, k])
                for k in range(adj.shape[1])),)


# tag, form, input, index (benchmarks/gather_probe.py:55-94)
CASES = [("rows (B,3F,5) <- (B,N,5)", rows, "pv5", "idx"),
         ("rows (B,3F,8) <- (B,N,8)", rows, "pv8", "idx"),
         ("lanes (B,6,3F) <- (B,6,N) ax-1", lanes, "pvt", "idx"),
         ("lanes (B,3F) <- (B,N) ax-1", rows, "pv1", "idx"),
         ("lanes 6x(B,3F) <- 6x(B,N)", lanes6, "pv1", "idx"),
         ("talax (B,px) <- (B,rows)", talax, "pvr", "bidx"),
         ("talax 16x(B,px) <- 16x(B,rows)", talax16, "pvr", "bidx"),
         ("talax (B,16,px) <- (B,16,rows)", talax_planes, "pvr16", "bidx"),
         ("adj rows (B,N*deg,3)+sum", adj_rows, "fn3", "adj"),
         ("adj per-k 6x(B,N,3) summed", adj_per_k, "fn3", "adj")]


def knobs() -> dict:
    return dict(batch=int(os.environ.get("BATCH", "128")))


def make_inputs(batch: int, device):
    """The reference's arrays from default_rng(0), in its draw order."""
    dev = _device(device)
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    d = dict(idx=t(rng.integers(0, N, size=(F3,)), torch.int32))
    for name, shape in (("pv5", (batch, N, 5)), ("pv8", (batch, N, 8)),
                        ("pvt", (batch, 6, N)), ("pv1", (batch, N)),
                        ("pvr", (batch, ROWS)), ("pvr16", (batch, 16, ROWS))):
        d[name] = t(rng.random(shape))
    d["bidx"] = t(rng.integers(0, ROWS, size=(batch, PX)), torch.int64)
    d["adj"] = t(rng.integers(0, N_FACES, size=(N, DEG)), torch.int32)
    d["fn3"] = t(rng.random((batch, N_FACES, 3)))
    return d


def summed(form):
    """The reference's case: the sum of the form's tensors' sums."""
    return lambda x, i: sum(y.sum() for y in form(x, i))


def run(d):
    """The reference's ten cases; returns the Cases."""
    cases = []
    timed = functools.partial(_timing.timed, inner=INNER, reps=REPS,
                              line=LINE, cases=cases)
    for tag, form, x, i in CASES:
        timed(tag, summed(form), d[x], d[i])
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(make_inputs(knobs()["batch"], args.device))


if __name__ == "__main__":
    main()
