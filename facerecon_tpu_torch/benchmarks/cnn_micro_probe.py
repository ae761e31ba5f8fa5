"""Micro-probes of the serving CNN's first stages (twin of
benchmarks/cnn_micro_probe.py), each a one-line experiment:
  1. lane padding: relu on (B,56,56,64) against (B,56,28,128), same
     bytes (XLA's question on the TPU; equal layouts here);
  2. the stem's max-pool: the 3x3/s2 pool against a max of 9 strided
     slices;
  3. the stem's conv: the 4x4 conv on 2x2 space-to-depth input (the
     port's fused stem, models/fused.py) against the native 7x7/s2 conv;
  and one stage-1 block, conv by conv.

  python -m facerecon_tpu_torch.benchmarks.cnn_micro_probe     # BATCH=128
  BATCH=2 python -m facerecon_tpu_torch.benchmarks.cnn_micro_probe --device cpu

env: BATCH (128). Data from np.random.default_rng(0) in the reference's
draw order. Tensors are NHWC as in the reference; a conv sees them as
channels_last NCHW views (the same memory). Each form keeps its padding:
conv4 (1,2) on each side pair, conv7 (2,3), SAME for the 1x1 and 3x3
convs, pool_rw SAME on 112 px ((0,1): window k covers rows 2k..2k+2), and
pool_slices (1,1) (window k covers rows 2k-1..2k+1). The two pools are
different functions, in the reference too (its comment calls the second
SAME); the probe times forms, so both stay as the reference computes
them. conv4 and conv7 compute in their weights' dtype; cuDNN rounds the
accumulator to that dtype before the f32 bias add, where XLA added the
bias to an f32 result (preferred_element_type). `--device` (default
cuda) raises without a card unless it is "cpu".
"""

from __future__ import annotations

import argparse
import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from facerecon_tpu_torch.bench import _device
from facerecon_tpu_torch.benchmarks import _timing
from facerecon_tpu_torch.models.fused import _same_pads, _stem_to_s2d

INNER, REPS = 8, 3
LINE = "{tag:36s}: {ms:7.2f} ms  [compile {ct:.0f}s]"


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _oihw(w_hwio: np.ndarray, dtype, dev):
    return torch.as_tensor(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1)), dtype=dtype, device=dev)


def s2d(x):
    """(B,H,W,C) -> (B,H/2,W/2,4C), channel order (dy, dx, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def conv4(x, w4, b0):
    """The s2d stem: 4x4/s1 conv on s2d(x), padding (1,2), + b0 (:73-79)."""
    y = F.conv2d(F.pad(_nchw(s2d(x.to(w4.dtype))), (1, 2, 1, 2)), w4)
    return (_nhwc(y).float() + b0).to(w4.dtype)


def conv7(x, w7, b0):
    """The native stem: 7x7/s2 conv, padding (2,3), + b0 (:81-87)."""
    y = F.conv2d(F.pad(_nchw(x.to(w7.dtype)), (2, 3, 2, 3)), w7, stride=2)
    return (_nhwc(y).float() + b0).to(w7.dtype)


def pool_rw(y):
    """relu, then the 3x3/s2 max-pool with SAME padding (:89-91)."""
    y = torch.relu(_nchw(y))
    (t, b), (l, r) = (_same_pads(y.shape[2], 3, 2),
                      _same_pads(y.shape[3], 3, 2))
    return _nhwc(F.max_pool2d(F.pad(y, (l, r, t, b), value=-math.inf), 3, 2))


def pool_slices(y):
    """relu, then the max of 9 strided slices of y padded (1,1) (:93-103)."""
    y = torch.relu(y)
    h, w = y.shape[1], y.shape[2]
    yp = F.pad(y, (0, 0, 1, 1, 1, 1), value=-math.inf)
    parts = [yp[:, a:a + h:2, b:b + w:2, :] for a in range(3)
             for b in range(3)]
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out


def block(x, w1a, w3, w1b):
    """One stage-1 bottleneck, 256->64->64->256, no biases, in the
    weights' dtype (:126-134)."""
    xc = _nchw(x)
    y = torch.relu(F.conv2d(xc, w1a))
    y = torch.relu(F.conv2d(y, w3, padding=1))
    y = F.conv2d(y, w1b)
    return _nhwc(torch.relu(y + xc))


def knobs() -> dict:
    return dict(batch=int(os.environ.get("BATCH", "128")))


def make_inputs(batch: int, device):
    """The reference's tensors, drawn from default_rng(0) in its order
    (weights as OIHW, the stem's s2d kernel by models/fused._stem_to_s2d):
    a dict of x64, x128, xf64, img, w7, w4, b0, w1a, w3, w1b, x256, x64b."""
    dev = _device(device)
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    d = dict(x64=t(rng.random((batch, 56, 56, 64)), bf16),
             x128=t(rng.random((batch, 56, 28, 128)), bf16))
    d["xf64"] = d["x64"].float()
    d["img"] = t(rng.random((batch, 224, 224, 3)), torch.float32)
    w7 = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    d["w7"] = _oihw(w7, bf16, dev)
    d["w4"] = _oihw(_stem_to_s2d(w7), bf16, dev)
    d["b0"] = t(rng.standard_normal((64,)) * 0.1, torch.float32)
    d["w1a"] = _oihw(rng.standard_normal((1, 1, 256, 64)) * .05, bf16, dev)
    d["w3"] = _oihw(rng.standard_normal((3, 3, 64, 64)) * .05, bf16, dev)
    d["w1b"] = _oihw(rng.standard_normal((1, 1, 64, 256)) * .05, bf16, dev)
    d["x256"] = t(rng.random((batch, 56, 56, 256)), bf16)
    d["x64b"] = t(rng.random((batch, 56, 56, 64)), bf16)
    return d


def run(d):
    """The reference's thirteen cases; returns the Cases."""
    cases = []
    timed = functools.partial(_timing.timed, inner=INNER, reps=REPS,
                              line=LINE, cases=cases)
    w4, w7, b0 = d["w4"], d["w7"], d["b0"]
    w1a, w3, w1b = d["w1a"], d["w3"], d["w1b"]

    def f32sum(y):
        return y.float().sum()
    timed("relu (B,56,56,64) bf16", lambda x: f32sum(torch.relu(x)), d["x64"])
    timed("relu (B,56,28,128) bf16", lambda x: f32sum(torch.relu(x)),
          d["x128"])
    timed("relu (B,56,56,64) f32", lambda x: torch.relu(x).sum(), d["xf64"])
    img = d["img"]
    timed("stem s2d-conv4 + rw-pool",
          lambda x: f32sum(pool_rw(conv4(x, w4, b0))), img)
    timed("stem s2d-conv4 + slice-pool",
          lambda x: f32sum(pool_slices(conv4(x, w4, b0))), img)
    timed("stem conv7/s2 + rw-pool",
          lambda x: f32sum(pool_rw(conv7(x, w7, b0))), img)
    timed("stem conv7/s2 + slice-pool",
          lambda x: f32sum(pool_slices(conv7(x, w7, b0))), img)
    timed("stem conv4 only", lambda x: f32sum(conv4(x, w4, b0)), img)
    timed("s2d only", lambda x: f32sum(s2d(x).to(torch.bfloat16)), img)
    timed("stage1 block (256->64->64->256)",
          lambda x: f32sum(block(x, w1a, w3, w1b)), d["x256"])
    timed("  1x1 256->64 alone", lambda x: f32sum(F.conv2d(_nchw(x), w1a)),
          d["x256"])
    timed("  3x3 64->64 alone",
          lambda x: f32sum(F.conv2d(_nchw(x), w3, padding=1)), d["x64b"])
    timed("  1x1 64->256 alone", lambda x: f32sum(F.conv2d(_nchw(x), w1b)),
          d["x64b"])
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(make_inputs(knobs()["batch"], args.device))


if __name__ == "__main__":
    main()
