#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (facerecon_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit; TF32 off.
  2. build: compiles every kernel of the port from csrc/ with nvcc.
  3. kernels: each kernel against its plain PyTorch version at full width
     (default config: 224 px, synthetic BFM with 70,688 faces), on the
     asset's raster row order at the main path's microbatch and on a
     shuffled row order (windows beyond the 64-chunk mask). Times both.
  4. end to end: Pipeline.reconstruct with the bf16 ResNet-50. A checked
     small batch (finite outputs, coverage, one kernel launch per call,
     agreement with the same float32 pipeline run on the CPU), then the
     main path: batch 256 in microbatches of 128, timed, with the launch
     counters reset just before and read just after.
  5. prints the per-kernel JSON line, the card line, and as the last line
     {"ok": true, "device": {...}}.
Uses random weights from a seed and random images, as bench.py does.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

MICRO = 128          # main-path microbatch
BATCH = 256          # images per timed step
REPS = 5             # timed steps
CHECK_BATCH = 8      # shuffled-order kernel check and checked e2e batch
H100_BYTES_S = 3.35e12   # HBM rate, H100 SXM data sheet
H100_F32_S = 67e12       # float32 rate outside the tensor cores
PAIR_FLOPS = 15      # f32 ops per pixel x triangle test (2 sub, 3 x 2 mul
                     # + 2 add, 1 add), comparisons not counted
DEVICE = "cuda"


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _popcount(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(x)
    for _ in range(32):
        n += x & 1
        x = x >> 1
    return n


def _live_pairs(win, cfg) -> int:
    """Pixel x triangle tests the kernel makes on these windows: the
    masked chunks of each column tile, plus every chunk beyond the mask
    for the whole band."""
    from facerecon_tpu_torch.ops.rasterize import col_width
    col_w = col_width(cfg.image_size, cfg.raster_cols)
    col_px = cfg.tile_h * col_w
    masked = int(_popcount(win.cmask).sum()) * 128 * col_px
    beyond = int(torch.clamp(win.bn.to(torch.int64) - 64, min=0).sum())
    return masked + beyond * 128 * col_px * cfg.raster_cols


def _inputs(cfg, bfm, coeff, order: str):
    """Records and windows for the kernel, in the asset's raster row
    order or in a shuffled face order."""
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry
    from facerecon_tpu_torch.ops.render import pack_render_records
    from facerecon_tpu_torch.ops.sh import illuminate
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    c = split_coeff(torch.as_tensor(coeff, device=DEVICE), cfg)
    geom = coeffs_to_geometry(c, bfm, cfg)
    rad = illuminate(geom.texture, geom.normals, c.gamma)
    if order == "raster_rows":
        rows, rid = bfm.raster_rows, bfm.raster_row_id
    else:
        perm = torch.as_tensor(np.random.default_rng(3).permutation(
            bfm.faces.shape[0]), device=DEVICE)
        rows, rid = bfm.faces[perm], perm
    s = cfg.image_size
    rec = pack_render_records(geom.verts_ndc, rad, rows, s, s,
                              R.padded_rows(rows.shape[0]))
    win = R.band_windows(geom.verts_ndc, rows, rid, s, s, cfg.tile_h,
                         cfg.raster_cols)
    return rec, win


def check_raster_shade(cfg, assets, rng):
    """Kernel against plain version, both row orders. Returns the kernel
    line's measured numbers at the main path's shapes."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import device_bfm
    bfm = device_bfm(assets, DEVICE)
    s = cfg.image_size
    kw = dict(height=s, width=s, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              n_faces=assets.n_faces)
    result, max_err = {}, 0.0
    for order, batch in (("raster_rows", MICRO), ("shuffled", CHECK_BATCH)):
        rec, win = _inputs(cfg, bfm, sample_coeffs(rng, cfg, batch), order)
        got = R.shade_windows(win, rec, **kw)
        torch.cuda.synchronize()
        ref = R.shade_windows_reference(win, rec, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got[0], ref[0]):
            bad = int((got[0] != ref[0]).sum())
            raise AssertionError(f"raster_shade tri_id differs from the "
                                 f"plain version at {bad} pixels ({order})")
        err = max(float((a - b).abs().max()) for a, b in zip(got[1:],
                                                             ref[1:]))
        if not err <= 1e-6:
            raise AssertionError(f"raster_shade color/bary differ by {err} "
                                 f"({order})")
        max_err = max(max_err, err)
        bn_max = int(win.bn.max())
        if order == "shuffled" and bn_max <= 64:
            raise AssertionError("shuffled order did not overflow the mask")
        pairs = _live_pairs(win, cfg)
        cover = float((got[0] >= 0).float().mean())
        ms = _time_ms(lambda: R.shade_windows(win, rec, **kw), reps=20)
        plain_ms = _time_ms(lambda: R.shade_windows_reference(win, rec, **kw),
                            reps=1, warmup=0)
        print(f"raster_shade[{order}] batch={batch} max bn={bn_max} "
              f"coverage={cover:.4f} live pairs={pairs} "
              f"kernel={ms:.4f} ms plain={plain_ms:.2f} ms "
              f"max|err|={err:.3g} (tri_id exact)")
        if order == "raster_rows":
            n_bytes = sum(t.numel() * t.element_size()
                          for t in (win.setup, rec, win.blo, win.bn,
                                    win.cmask, *got))
            t_bytes = n_bytes / H100_BYTES_S * 1e3
            t_ops = pairs * PAIR_FLOPS / H100_F32_S * 1e3
            print(f"raster_shade bound inputs: {n_bytes} bytes -> "
                  f"{t_bytes:.4f} ms; {pairs * PAIR_FLOPS} f32 ops -> "
                  f"{t_ops:.4f} ms")
            result = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations")
    del bfm
    torch.cuda.empty_cache()
    return dict(result, max_abs_err=max_err)


def check_end_to_end(cfg, assets, rng):
    """Checked small batch, a CPU float32 comparison, then the timed main
    path. Returns the main path's launch counts."""
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.pipeline import make_pipeline
    s = cfg.image_size
    pipe = make_pipeline(cfg, assets, device=DEVICE)
    images = torch.rand((CHECK_BATCH, s, s, 3),
                        generator=torch.Generator().manual_seed(1))
    before = _build.LAUNCHES["raster_shade"]
    for k in range(2):
        cv, _, out = pipe.reconstruct(images)
        torch.cuda.synchronize()
        if _build.LAUNCHES["raster_shade"] != before + k + 1:
            raise AssertionError("reconstruct did not launch raster_shade "
                                 "exactly once")
    for name, t in (("coeffs", cv), ("image", out.image),
                    ("bary", out.bary), ("verts", out.geometry.verts_world)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name}")
    cover = float(out.mask.mean())
    if not cover > 0.05:
        raise AssertionError(f"face coverage {cover}")
    print(f"checked batch {CHECK_BATCH}: coverage {cover:.4f}, "
          f"|coeff| max {float(cv.abs().max()):.4f}")

    # the same float32 pipeline on the card and on the CPU (plain path)
    small = images[:2]
    outs = []
    for dev in (DEVICE, "cpu"):
        p32 = make_pipeline(cfg, assets, device=dev, dtype=torch.float32)
        cv32, _, o32 = p32.reconstruct(small)
        outs.append((cv32.cpu(), o32.tri_id.cpu(), o32.image.cpu(),
                     o32.geometry.verts_world.cpu()))
        del p32
    (cg, tg, ig, vg), (cc, tc, ic, vc) = outs
    cdiff = float((cg - cc).abs().max()) / float(cc.abs().max())
    same = tg == tc
    agree = float(same.float().mean())
    vmae = float((vg - vc).abs().mean())
    idiff = float((ig - ic).abs()[same].max())
    print(f"float32 card vs CPU: coeff rel diff {cdiff:.3g}, vertex MAE "
          f"{vmae:.3g}, tri_id agreement {agree:.6f}, image diff where "
          f"tri_id agrees {idiff:.3g}")
    if not (cdiff < 1e-4 and vmae < 1e-5 and agree >= 0.999
            and idiff < 1e-3):
        raise AssertionError("card pipeline disagrees with the CPU pipeline")
    bf16_diff = float((cv[:2].cpu() - cc).abs().max())
    print(f"bf16 model vs float32 CPU: coeff max diff {bf16_diff:.3g}")

    # stage split of one microbatch (CUDA events, after warm-up)
    batch = torch.rand((BATCH, s, s, 3),
                       generator=torch.Generator().manual_seed(2))
    micro = [batch[i:i + MICRO].to(DEVICE) for i in range(0, BATCH, MICRO)]
    _stage_split(pipe, micro[0])

    # the main path: counts from 0, then batch 256 in microbatches
    _build.reset_launches()
    n_calls = 0

    def step():
        nonlocal n_calls
        for im in micro:
            pipe.reconstruct(im)
            n_calls += 1

    step()                                     # warm-up (counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        step()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / REPS
    launches = dict(_build.LAUNCHES)
    print(f"end to end: {BATCH / dt:.1f} faces/s (batch {BATCH} in "
          f"microbatches of {MICRO}, bf16 ResNet-50, {s} px, "
          f"{dt * 1e3:.1f} ms/step, {REPS} steps) on {_card_line()}")
    print(f"main path: {n_calls} reconstruct calls, launches {launches}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    return launches


def _stage_split(pipe, images):
    """ms of each stage of one reconstruct call, timed with CUDA events."""
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry
    from facerecon_tpu_torch.ops.render import pack_render_records
    from facerecon_tpu_torch.ops.sh import illuminate
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    cfg, bfm, s = pipe.cfg, pipe.bfm, pipe.cfg.image_size
    pipe.reconstruct(images)
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    with torch.no_grad():
        mark("start")
        c = split_coeff(pipe.model(images), cfg)
        mark("cnn")
        geom = coeffs_to_geometry(c, bfm, cfg)
        rad = illuminate(geom.texture, geom.normals, c.gamma)
        mark("geometry+sh")
        rec = pack_render_records(geom.verts_ndc, rad, bfm.raster_rows, s, s,
                                  R.padded_rows(bfm.raster_rows.shape[0]))
        mark("records")
        win = R.band_windows(geom.verts_ndc, bfm.raster_rows,
                             bfm.raster_row_id, s, s, cfg.tile_h,
                             cfg.raster_cols)
        mark("binning")
        R.shade_windows(win, rec, height=s, width=s, tile_h=cfg.tile_h,
                        n_cols=cfg.raster_cols, n_faces=bfm.faces.shape[0])
        mark("raster_shade")
    torch.cuda.synchronize()
    parts = [f"{n} {a.elapsed_time(b):.3f}"
             for (_, a), (n, b) in zip(marks[:-1], marks[1:])]
    total = marks[0][1].elapsed_time(marks[-1][1])
    print(f"stage ms (microbatch {images.shape[0]}): " + ", ".join(parts)
          + f"; total {total:.3f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from facerecon_tpu_torch.config import default_config
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.utils.bfm import synthetic_bfm

    card = _card_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = default_config()
    assets = synthetic_bfm(cfg, 0)
    print(f"config: {cfg.image_size} px, {assets.n_vertices} vertices, "
          f"{assets.n_faces} faces, {assets.raster_rows.shape[0]} raster "
          f"rows, tile_h {cfg.tile_h}, {cfg.raster_cols} columns")
    rng = np.random.default_rng(0)
    measured = check_raster_shade(cfg, assets, rng)
    launches = check_end_to_end(cfg, assets, rng)

    kernels = [dict(
        name="raster_shade", route="cuda",
        source="facerecon_tpu_torch/csrc/raster_shade.cu",
        replaces="facerecon_tpu/ops/rasterize_pallas.py:133",
        launches=launches["raster_shade"],
        max_abs_err=measured["max_abs_err"], ms=measured["ms"],
        plain_ms=measured["plain_ms"], bound_ms=measured["bound_ms"],
        bound_by=measured["bound_by"], library_ms=None)]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
