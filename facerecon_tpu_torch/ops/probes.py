"""Probe kernels: microbenchmarks of the rasterizers' building blocks
(twin of benchmarks/ctzloop_probe.py).

`ctz_walk` -> `csrc/ctz_walk.cu` (K6): the live-chunk walk over the set
bits of one 32-bit mask word per program, with the z-test's covered-depth
minimum over each live chunk. No driver calls it; `chip_smoke.py` times
it per live chunk. As the rasterizers' wrappers do, it launches the
kernel on CUDA tensors, takes its plain PyTorch version
(`ctz_walk_reference`) on CPU tensors, and counts launches in
`_build.LAUNCHES`.
"""

from __future__ import annotations

import torch

from facerecon_tpu_torch.ops import _build

CHUNK = 128            # triangles per chunk
COL_PX = 112           # pixels per program
SETUP_SHAPE = (8, 64 * CHUNK)   # probe setup: fields 0..5 used


def ctz_walk(mask, setup):
    """K6's wrapper. mask (n_prog,) int32, one chunk mask word per
    program; setup (8, 8192) f32. Returns (n_prog, 112) f32: for pixel p
    of program t, the minimum over the set bits k of mask[t] of the
    minimum over triangles j of chunk k of ez = s4*p + s5 where
    e0 = s0*p + s1 >= 0, e1 = s2*p + s3 >= 0 and e0 + e1 <= 1, with
    s_f = setup[f, 128k + j]; +inf where nothing is covered."""
    dev = setup.device
    _build.check_tensors(dev, {
        "mask": (mask, torch.int32, (mask.shape[0],)),
        "setup": (setup, torch.float32, SETUP_SHAPE),
    })
    if not _build.on_card(dev):
        return ctz_walk_reference(mask, setup)
    n_prog = mask.shape[0]
    out = torch.empty((n_prog, COL_PX), dtype=torch.float32, device=dev)
    if n_prog:
        _build.launch("ctz_walk", dev, (mask, setup, out), (n_prog,))
    return out


def ctz_walk_reference(mask, setup):
    """Plain PyTorch version of K6, on the same inputs: the covered-depth
    minimum of each pixel over each of the 32 chunks a word can name,
    then per program the minimum over its set bits (min is exact, so the
    order does not matter). The float ops are the kernel's, in its
    order."""
    s = setup[:6, :32 * CHUNK].reshape(6, 32, CHUNK)
    p = torch.arange(COL_PX, device=setup.device,
                     dtype=torch.float32)[:, None, None]
    e0 = s[0] * p + s[1]                                # (112, 32, 128)
    e1 = s[2] * p + s[3]
    ez = s[4] * p + s[5]
    cov = (e0 >= 0.0) & (e1 >= 0.0) & (e0 + e1 <= 1.0)
    chunk_min = torch.where(cov, ez, float("inf")).amin(dim=2)  # (112, 32)
    shift = torch.arange(32, device=mask.device, dtype=torch.int64)
    bits = ((mask.to(torch.int64)[:, None] >> shift) & 1).bool()  # (n, 32)
    return torch.where(bits[:, None, :], chunk_min,
                       float("inf")).amin(dim=2)
