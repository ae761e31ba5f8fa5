"""The live-chunk walk in its two forms (twin of
benchmarks/ctzloop_probe.py, kernel K6), at the reference's shape:

  python -m facerecon_tpu_torch.benchmarks.ctzloop_probe
  python -m facerecon_tpu_torch.benchmarks.ctzloop_probe --device cpu

2,048 programs, each a mask word with `live` of its 32 bits set (4, 8,
16, 32), drawn as the reference draws them from default_rng(0), after
the (8, 8192) setup rows. looped=1 is K6 as the port runs it
(ops/probes.ctz_walk: __ffs jumps to each set bit); looped=0 is the
reference's other form, each of the 32 bits tested in turn and a clear
one skipped: a variant build of the same source (csrc/ctz_walk.cu with
CTZ_UNROLLED set), launched by this module. Both compute the function
of the plain version (ops/probes.ctz_walk_reference), which CPU tensors
take. For each (live, looped) it prints the reference's line: the first
call as `compile` (on the card the build and first launch), then the
host clock over REPS calls ended by a synchronisation. `--device`
(default cuda) raises without a card unless it is "cpu".
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from facerecon_tpu_torch.bench import _device, _sync
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops import probes

N_PROG = 2048
LIVE = (4, 8, 16, 32)
REPS = 20
UNROLLED = ("CTZ_UNROLLED",)


def inputs(device, n_prog: int = N_PROG):
    """(setup (8, 8192) f32, {live: mask (n_prog,) int32}) from
    default_rng(0) in the reference's draw order."""
    dev = _device(device)
    rng = np.random.default_rng(0)
    setup = torch.as_tensor(rng.standard_normal(probes.SETUP_SHAPE),
                            dtype=torch.float32, device=dev)
    masks = {}
    for live in LIVE:
        bits = np.zeros(n_prog, np.int64)
        for r in range(n_prog):
            idx = rng.choice(32, size=live, replace=False)
            bits[r] = int(np.sum(1 << idx.astype(np.int64)))
        masks[live] = torch.as_tensor(bits.astype(np.uint32).view(np.int32),
                                      device=dev)
    return setup, masks


def walk(mask, setup, looped: bool):
    """K6's function: looped through its wrapper (ops/probes.ctz_walk);
    else on CUDA tensors the CTZ_UNROLLED build, launched here with the
    wrapper's checks. CPU tensors take the plain version either way."""
    dev = setup.device
    if looped or not _build.on_card(dev):
        return probes.ctz_walk(mask, setup)
    _build.check_tensors(dev, {
        "mask": (mask, torch.int32, (mask.shape[0],)),
        "setup": (setup, torch.float32, probes.SETUP_SHAPE),
    })
    n_prog = mask.shape[0]
    out = torch.empty((n_prog, probes.COL_PX), dtype=torch.float32,
                      device=dev)
    if n_prog:
        _build.launch("ctz_walk", dev, (mask, setup, out), (n_prog,),
                      UNROLLED)
    return out


@torch.no_grad()
def run(device) -> list:
    """The reference's main: for each live count, looped 0 then 1, the
    first call's seconds and the seconds a call over REPS. Returns
    (live, looped, compile_s, seconds) in print order."""
    setup, masks = inputs(device)
    dev = setup.device
    rows = []
    for live, mask in masks.items():
        for looped in (False, True):
            t0 = time.perf_counter()
            walk(mask, setup, looped)
            _sync(dev)
            ct = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(REPS):
                walk(mask, setup, looped)
            _sync(dev)
            dt = (time.perf_counter() - t0) / REPS
            n_prog = mask.shape[0]
            per_chunk = dt / n_prog / live * 1e9
            print(f"live={live:2d} looped={int(looped)} compile {ct:5.1f}s "
                  f"run {dt*1e3:7.3f} ms  {dt/n_prog*1e9:7.1f} ns/prog "
                  f"{per_chunk:6.1f} ns/chunk", flush=True)
            rows.append((live, int(looped), ct, dt))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
