"""Rasterizer benchmark (twin of benchmarks/raster_bench.py): the z-test
alone (kernel K4) through rasterize_positions.

  python -m facerecon_tpu_torch.raster_bench [--batch 64] [--check] [--cull]
  python -m facerecon_tpu_torch.raster_bench --batch 1 --reps 1 --size 32 \
      --check --device cpu                             # plain path

The vertices come from default_config() at 224 px whatever --size says,
as the reference's do: sample_coeffs(np.random.default_rng(0)) through
the geometry, then rasterized at --size x --size with --tileh pixel rows
a band, one column and the faces in the asset's own order (no raster row
order), culling back faces with --cull. One call returns (tri_id, its
sum); it runs once, then `--reps` and 2 * `--reps` times, each run ended
by a host read of the last call's sum. `--check` compares rasterize_batch
on the device (K4 and the decode) with rasterize_batch on a CPU copy (the
plain version, which takes the role of the reference's rasterize_tiled
fallback) on the first face. `--device` (default cuda) raises without a
card unless it is "cpu".
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from facerecon_tpu_torch.bench import _device
from facerecon_tpu_torch.config import default_config
from facerecon_tpu_torch.data.synthetic import sample_coeffs
from facerecon_tpu_torch.ops import rasterize as R
from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry, device_bfm
from facerecon_tpu_torch.utils.bfm import synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff


@torch.no_grad()
def geometry(batch: int = 64, device="cuda", cfg=None, assets=None):
    """(verts_ndc (B, N, 3), faces (F, 3)) on the device: default_config()
    (or `cfg`) and synthetic_bfm(cfg, 0) (or `assets`), coefficients from
    sample_coeffs(np.random.default_rng(0))."""
    dev = _device(device)
    cfg = default_config() if cfg is None else cfg
    bfm = device_bfm(synthetic_bfm(cfg, 0) if assets is None else assets,
                     dev)
    cv = torch.as_tensor(sample_coeffs(np.random.default_rng(0), cfg, batch),
                         device=dev)
    return coeffs_to_geometry(split_coeff(cv, cfg), bfm, cfg).verts_ndc, \
        bfm.faces


def make_pos_fn(size: int, tile_h: int = 8, cull: bool = False) -> Callable:
    """The reference's pos_fn: (verts_ndc, faces) -> (tri_id (B, S, S),
    its sum), through rasterize_positions (one K4 launch)."""
    def pos_fn(v, faces):
        pos = R.rasterize_positions(v, faces, height=size, width=size,
                                    tile_h=tile_h, cull_backfaces=cull)[0]
        return pos, pos.sum()
    return pos_fn


def check(vndc, faces, size: int) -> int:
    """rasterize_batch on the first face on its device against the same on
    a CPU copy (the plain version): the pixels whose tri_id differs."""
    kw = dict(height=size, width=size)
    got = R.rasterize_batch(vndc[:1], faces, **kw)[0]
    want = R.rasterize_batch(vndc[:1].cpu(), faces.cpu(), **kw)[0]
    return int((got.cpu() != want).sum())


def run(pos_fn: Callable, vndc, faces, reps: int) -> dict:
    """The reference's timing of pos_fn, with its lines printed. Returns
    {"chk": the first call's sum, "runs": [(reps, ms a batch, faces/s)],
    "out": the last call's tri_id}."""
    batch = vndc.shape[0]
    t0 = time.time()
    out, chk = pos_fn(vndc, faces)
    chk = int(chk)
    print(f"kernel compile+1st ({time.time()-t0:.1f}s) chk={chk}",
          flush=True)
    runs = []
    for n in (reps, 2 * reps):
        t0 = time.time()
        for _ in range(n):
            out, s = pos_fn(vndc, faces)
        int(s)      # the host read: it waits on the last call
        dt = (time.time() - t0) / n
        print(f"raster reps={n}: {dt*1000:.1f} ms/{batch} -> "
              f"{batch/dt:.0f} faces/s", flush=True)
        runs.append((n, dt * 1e3, batch / dt))
    return {"chk": chk, "runs": runs, "out": out}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check", action="store_true",
                    help="verify vs the plain version on one face")
    ap.add_argument("--cull", action="store_true")
    ap.add_argument("--tileh", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain PyTorch "
                         "path)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """run()'s result, plus "mismatch" with --check."""
    args = parse_args(argv)
    t0 = time.time()
    vndc, faces = geometry(args.batch, args.device)
    float(vndc.sum())
    print(f"geom ready ({time.time()-t0:.1f}s)", flush=True)
    h = w = args.size
    mismatch = None
    if args.check:
        mismatch = check(vndc, faces, h)
        print(f"mismatch vs plain: {mismatch} / {h*w}", flush=True)
    res = run(make_pos_fn(h, args.tileh, args.cull), vndc, faces, args.reps)
    return dict(res, mismatch=mismatch)


if __name__ == "__main__":
    main()
