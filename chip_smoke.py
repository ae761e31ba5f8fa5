#!/usr/bin/env python3
"""Build report and kernel table of the PyTorch/CUDA port
(facerecon_tpu_torch) on one GPU.

    python3 chip_smoke.py

The card's holds live in the `cuda` tests (tests/test_torch_cuda.py and
tests/test_torch_deca.py) and the end-to-end figures in the benchmark
(perfbench); this script prints what neither gives: how each kernel
builds, and each kernel's time beside its plain version's and its bound.

Phases (any failed check raises, and the script exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit; TF32 off.
  2. build: compiles every kernel of the port from csrc/ with nvcc, and
     prints each one's ptxas registers and spills and the opcode mix of
     its machine code (cuobjdump).
  3. kernels, each held once against its plain version on the inputs it
     is then timed on (default config: 224 px, synthetic BFM with 70,688
     faces): K1 (raster_shade), K2 (raster_select) and K4 (raster_pos)
     at batch 128 on the asset's raster row order (tri_id exact; K1
     color and bary within 1e-6, K2 and K4 exact);
     K3 (select_grad) on K2's winner rows with a cotangent drawn from a
     seed (within 1e-5 x max |ref|, two launches bitwise equal), beside
     one index_add_ of the same sums and a zero fill of its output; the
     binning kernels (csrc/binning.cu: bin_setup, bin_windows, through
     ops/rasterize.band_windows) at the headline's shape (224 px, tile_h
     4 x 7 columns, batch 128) and render512's (512 px, tile_h 2 x 8,
     batch 32), Windows bit for bit, with each kernel's device ms; the
     geometry kernel (csrc/geometry.cu, through ops/geometry.vertex_pass)
     at the same two batches on the basis products of sample_coeffs
     faces (shape and texture bit for bit, the rest within GEO_ATOL, the
     landmarks within GEO_ATOL relative), with the whole layer's ms and
     its device ops'; the record kernel (csrc/records.cu, through
     ops/render.pack_render_records and pack_texture_records) at the
     headline's 128 at 224 px, render512's 32 at 512 px and DECA's 256
     with the UV rows (bit for bit, as int32 bits); DECA's textured kernel (csrc/raster_texture.cu) on
     the inputs of the benchmark cell deca-render224.b512 (its
     configuration's seeded FLAME stand-ins, 256 codes from the cell's
     sampler at seed TEX_SEED, 224 px, tile_h 4 x 7 columns; tri_id
     exact, colour and barycentrics within 1e-6); DECA's detail kernels
     on the inputs of the benchmark cell deca-detail224.b512 (its seeded
     stand-ins and decoder at seed DETAIL_SEED, its microbatch of 256,
     256^2 maps, 224 px, tile_h 4 x 7 columns): the UV detail kernel
     (csrc/uv_detail.cu, through ops/detail.uv_detail; the displacement
     map bit for bit, the texture and the detail normals within 1e-6)
     and the fetch of the texture it shaded (raster_texfetch_kernel in
     csrc/raster_texture.cu, through ops/rasterize.texfetch_windows;
     tri_id exact, colour and barycentrics within 1e-6), each launched
     alone, and before them the decoder's kernels (csrc/upconv.cu: 5
     upconv and 1 outconv launches, within twice the eager cuDNN-TF32
     decoder's gap to the float32 decoder, its library_ms the eager
     decoder on channels_last tensors). Each kernel's ms a
     launch (CUDA events), its plain version's ms and its bound. The ops
     bounds of K1, K2 and K4 count what the inputs need, the same for
     any design (the pixel centers in each triangle's bounding box, 7
     adds a test, plus the products each of its pixel columns and rows
     shares), printed beside the tests the kernels issue
     (ops/rasterize.tests_issued); their bytes bounds what they must read
     (the walked setup chunks, the winners' record sectors). The
     binning's bound is the padded setup written and the vertices read;
     the geometry's the bases read, the six planes and the landmarks
     written, and the basis products' FMAs; the records' the record
     written and the two (B, N, 3) planes read; the textured kernel's
     perfbench/work_flame.texture_work (the bytes read and written once,
     the distinct albedo texels the covered pixels' bilinear footprints
     read, and the tests the inputs need); the UV detail kernel's
     perfbench/work_detail.uv_detail_bytes and the fetch's
     work_detail.texfetch_work; the decoder's perfbench/work_decoder
     (per layer the larger of FLOPs at the TF32 peak and bytes).
  4. K5 (floor): K1, K2 and K4 alone on inputs precomputed once at
     benchmarks/floor_probe.py's defaults (batch 128, tile_h 2, 4 columns,
     frontal coefficients), each real-mask call held against its plain
     version on its first 32 images, then timed with the real chunk masks
     and with every bit set: ms per launch and the cost of each tested
     chunk added. Then the ablated builds of each (the reference's
     RP_ABLATE through the twin facerecon_tpu_torch/benchmarks/
     floor_probe.py: dma, eval, sel, pack, cull and merge alone, and the
     skeleton sel,eval,dma,pack; K4 has no sel), all built together, each
     launched on the real masks and timed beside the full kernel with its
     SASS opcode mix (what the stripped builds compute is held by the
     `cuda` tests). The phase prints its wall time.
  5. K6 (ctz_walk): the live-chunk walk probe against its plain version
     at benchmarks/ctzloop_probe.py's shape (2,048 programs, 4/8/16/32
     live bits), exactly equal, then timed: ns per live chunk; its bound
     is that of the per-program walk the probe makes, with the function's
     own bound printed beside it. The probe's other walk (looped=0: each
     bit tested in turn, the CTZ_UNROLLED build, through the twin
     benchmarks/ctzloop_probe.py) is timed beside the __ffs walk.
  6. the probes' twins (facerecon_tpu_torch/benchmarks/: calib_probe,
     roofline_probe, cnn_probe, cnn_micro_probe, gather_probe and
     scatter_probe, twins of benchmarks/<the same>.py) through their own
     functions at the reference's defaults, each printing its case lines
     and the card: the chained timer's intercept, the card's copy and
     bf16 matmul rates beside the data sheet's, the fused CNN's stage
     deltas at batch 64, the stem forms, the gather forms, the
     scatter-min, the element gather and the sort. Every time and sum
     finite, and no port kernel launched.
  7. prints the per-kernel JSON line, the card line, and as the last line
     {"ok": true, "device": {...}}.
Inputs come from seeds.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MICRO = 128          # inference main-path microbatch
REPS = 5             # timed calls of the plain versions
TRAIN_BATCH = 128    # training main-path batch (K2's and K3's)
H100_BYTES_S = 3.35e12   # HBM rate, H100 SXM data sheet
H100_F32_S = 132 * 128 * 1.98e9  # f32 ops a second: one unfused op per
                         # instruction (the kernels build with -fmad=false,
                         # so no multiply-add fuses), 128 lanes on each of
                         # 132 SMs at 1.98 GHz; the data sheet's 67e12
                         # counts a fused multiply-add as 2 ops
TEST_ADDS = 7        # f32 adds per pixel x triangle test (2 each for the
                     # edge forms e0, e1 and the depth, 1 for e0 + e1)
AXIS_OPS = 4         # f32 ops per triangle for each pixel column (row) of
                     # its bounding box: qx = px - x0, then the three
                     # forms' a * qx, which the column's pixels share and
                     # no design can skip (-fmad=false keeps each product
                     # an op); comparisons not counted
WALK_FLOPS = 7       # f32 ops per ctz_walk test (3 x (mul + add), 1 add)
FLOOR_BATCH = 128    # K5: benchmarks/floor_probe.py's defaults
FLOOR_TILE_H = 2
FLOOR_COLS = 4
FLOOR_CHECK = 32     # K5 images held against the plain versions
FLOOR_SKELETON = "sel,eval,dma,pack"   # floor_probe.py:6's skeleton
WALK_PROGS = 2048    # K6: benchmarks/ctzloop_probe.py's shape
WALK_REPORTED = 8    # live bits of the K6 line in the kernels JSON
# the binning's shapes: (where, px, tile_h, columns, batch)
BIN_RUNS = (("headline", 224, 4, 7, MICRO),
            ("render512", 512, 2, 8, 32))
TEX_CELL = "deca-render224.b512"   # DECA's textured kernel: the cell,
TEX_BATCH = 256          # its microbatch,
TEX_SEED = 22            # and the seed of the codes
DETAIL_CELL = "deca-detail224.b512"   # DECA's detail kernels: the cell,
DETAIL_SEED = 26         # the seed of its codes and decoder, and its
                         # microbatch is TEX_BATCH
GEO_RUNS = (("headline", 224, MICRO), ("render512", 512, 32))
GEO_ATOL = 1e-6          # geometry kernel vs its plain version on the card
# the record kernel's BFM shapes: (where, px, batch); DECA's is TEX_CELL's
REC_RUNS = (("headline", 224, MICRO), ("render512", 512, 32))
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


def _needed_tests(win, height: int, width: int):
    """(tests, f32 ops) that these windows' triangles need, the same for
    any design: for each live setup row (a dead or slack row has wc0 =
    -3e38), the pixel centers inside its screen bounding box, clipped to
    the image, times TEST_ADDS, plus AXIS_OPS for each pixel column and
    row of that box. The box: vertex 0 is the anchor (fields 9, 10); the
    other two come back from the affine forms in float64 (the forms are
    the inverse of [[u1, u2], [v1, v2]] scaled: det = wa0 wb1 - wb0 wa1 =
    1 / area, u2 = -wb1 area, v2 = wa1 area, u1 = u2 - wb0 area, v1 = v2
    + wa0 area)."""
    f = win.setup[:, :11].to(torch.float64)
    wa0, wb0, wc0, wa1, wb1 = f[:, 0], f[:, 1], f[:, 2], f[:, 3], f[:, 4]
    det = wa0 * wb1 - wb0 * wa1
    live = (wc0 > -1e38) & (det != 0)
    area = 1.0 / torch.where(live, det, 1.0)
    u2, v2 = -wb1 * area, wa1 * area
    u1, v1 = u2 - wb0 * area, v2 + wa0 * area
    zero = torch.zeros_like(u1)
    xs = f[:, 9][..., None] + torch.stack([zero, u1, u2], dim=-1)
    ys = f[:, 10][..., None] + torch.stack([zero, v1, v2], dim=-1)

    def centers(lo, hi, size):    # pixel centers p + 0.5 in [lo, hi]
        first = torch.clamp(torch.ceil(lo - 0.5), min=0)
        last = torch.clamp(torch.floor(hi - 0.5), max=size - 1)
        return torch.clamp(last - first + 1, min=0).nan_to_num(0.0)
    nx = centers(xs.amin(-1), xs.amax(-1), width)
    ny = centers(ys.amin(-1), ys.amax(-1), height)
    nx, ny = nx * live, ny * live
    some = (nx * ny) > 0
    tests = int((nx * ny).sum())
    ops = TEST_ADDS * tests + AXIS_OPS * int(((nx + ny) * some).sum())
    return tests, ops


def _tests_made(win, tile_h: int, n_cols: int, width: int) -> dict:
    """The tests of K1, K2 and K4 on these windows (square images):
    `needed`/`needed_ops` what the inputs need (_needed_tests, the ops
    bound's count), `issued` what the kernels issue
    (ops/rasterize.tests_issued: `mask` the coverage tests of the
    micro-tile masks, `list` the z-tests of the lanes' lists)."""
    from facerecon_tpu_torch.ops import rasterize as R
    needed, needed_ops = _needed_tests(win, width, width)
    mask, lists = R.tests_issued(win, height=width, width=width,
                                 tile_h=tile_h, n_cols=n_cols)
    return dict(needed=needed, needed_ops=needed_ops, issued=mask + lists,
                mask=mask, list=lists)


def _tests_line(what: str, t: dict) -> str:
    return (f"{what} tests needed {t['needed']} ({t['needed_ops']} f32 "
            f"ops), issued {t['issued']} (mask {t['mask']} + lists "
            f"{t['list']})")


def _inputs(cfg, bfm, coeff):
    """Records and windows for the kernel, in the asset's raster row
    order."""
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry
    from facerecon_tpu_torch.ops.render import pack_render_records
    from facerecon_tpu_torch.ops.sh import illuminate
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    c = split_coeff(torch.as_tensor(coeff, device=DEVICE), cfg)
    geom = coeffs_to_geometry(c, bfm, cfg)
    rad = illuminate(geom.texture, geom.normals, c.gamma)
    rows, rid = bfm.raster_rows, bfm.raster_row_id
    s = cfg.image_size
    rec = pack_render_records(geom.verts_ndc, rad, rows, s, s,
                              R.padded_rows(rows.shape[0]))
    win = R.band_windows(geom.verts_ndc, rows, rid, s, s, cfg.tile_h,
                         cfg.raster_cols)
    return rec, win


def _bound(n_bytes: int, n_ops: int, name: str):
    """(bound_ms, bound_by) for moving n_bytes and doing n_ops f32 ops."""
    t_bytes = n_bytes / H100_BYTES_S * 1e3
    t_ops = n_ops / H100_F32_S * 1e3
    print(f"{name} bound inputs: {n_bytes} bytes -> {t_bytes:.4f} ms; "
          f"{n_ops} f32 ops -> {t_ops:.4f} ms")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _raster_bytes(win, got, rec_fields: int, n_cols: int,
                  n_faces: int) -> int:
    """Bytes K1, K2 or K4 must move on these windows, each read once: the
    12 staged setup fields (0..10 and the id) of the distinct chunks some
    column tile's walk visits (its masked chunks of the first 64, then
    every chunk beyond), blo, bn and cmask, the first rec_fields record
    fields over the 32-byte sectors that hold a winner's row, and every
    output."""
    from facerecon_tpu_torch.ops import rasterize as R
    setup = win.setup
    bsz, _, rows = setup.shape
    n_chunks = rows // R._CHUNK
    n_bands = win.blo.shape[1]
    dev = setup.device
    lane = torch.arange(32, device=dev, dtype=torch.int64)
    words = win.cmask.view(bsz, n_bands, n_cols, R._MWORDS).to(torch.int64)
    masked = ((words[..., None] >> lane) & 1).reshape(
        bsz, n_bands, n_cols, 64).bool().any(dim=2)          # (B, T, 64)
    k = torch.arange(max(64, int(win.bn.max())), device=dev)
    walked = torch.nn.functional.pad(masked, (0, k.numel() - 64)) | (
        (k >= 64) & (k < win.bn[..., None]))                 # (B, T, K)
    chunk = torch.where(walked, (win.blo[..., None] + k).clamp(
        max=n_chunks - 1), n_chunks).to(torch.int64)
    seen = torch.zeros((bsz, n_chunks + 1), dtype=torch.int32, device=dev)
    seen.scatter_(1, chunk.reshape(bsz, -1), 1)
    n_bytes = int(seen[:, :n_chunks].sum()) * R._CHUNK * 12 * 4
    if rec_fields:
        # a winner's row: the setup row that carries its face id (slack
        # rows carry id 0 and wc0 = -3e38)
        won = torch.zeros((bsz, n_faces + 1), dtype=torch.bool, device=dev)
        won.scatter_(1, (got[0].reshape(bsz, -1) + 1).to(torch.int64), True)
        ids = setup[:, 12].to(torch.int64).clamp(0, n_faces - 1)
        row_won = won[:, 1:].gather(1, ids) & (setup[:, 2] > -1e38)
        sectors = int(row_won.view(bsz, rows // 8, 8).any(dim=2).sum())
        n_bytes += sectors * 32 * rec_fields
    return n_bytes + _nbytes(win.blo, win.bn, win.cmask, *got)


def _compare_shade(got, ref, where):
    """K1's color and bary within 1e-6 of the plain version's."""
    err = max(float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:]))
    if not err <= 1e-6:
        raise AssertionError(f"raster_shade color/bary differ by {err} "
                             f"({where})")
    return err


def _compare_exact(name, fields):
    """A compare that holds each named output exactly equal."""
    def compare(got, ref, where):
        for k, what in fields:
            if not torch.equal(got[k], ref[k]):
                bad = int((got[k] != ref[k]).sum())
                raise AssertionError(f"{name} {what} differs from the plain "
                                     f"version at {bad} elements ({where})")
        return 0.0
    return compare


def _raster_kernels():
    """The rasterizer kernels: name -> (wrapper, plain version, compare of
    the outputs after tri_id, the record fields its epilogue loads: K1
    fields 0..16, K2 0..19, K4 none). The wrappers and plain versions all
    take (win, rec, **kw). K2's sel is a copy of record values and K4
    keeps the plain version's float32 order, so both are held exactly."""
    from facerecon_tpu_torch.ops import rasterize as R
    return {
        "raster_shade": (R.shade_windows, R.shade_windows_reference,
                         _compare_shade, R._GRAD),
        "raster_select": (R.select_windows, R.select_windows_reference,
                          _compare_exact("raster_select",
                                         ((1, "row"), (2, "sel"))), R._SEL),
        "raster_pos": (lambda win, rec, **kw: R.pos_windows(win, **kw),
                       lambda win, rec, **kw: R.pos_windows_reference(
                           win, **kw),
                       _compare_exact("raster_pos",
                                      ((1, "zbuf"), (2, "row"))), 0),
    }


def _hold(name, got, ref, where) -> float:
    """A rasterizer's outputs against its plain version's: tri_id exactly
    equal, then the kernel's own compare. Returns the max |err|."""
    if not torch.equal(got[0], ref[0]):
        bad = int((got[0] != ref[0]).sum())
        raise AssertionError(f"{name} tri_id differs from the plain "
                             f"version at {bad} pixels ({where})")
    return _raster_kernels()[name][2](got, ref, where)


def _hold_windows(got, ref, where) -> float:
    """The binning kernels' Windows against the plain version's, bit for
    bit: the setup as int32 bits over every field and padded row, blo, bn
    and cmask equal. Returns 0.0 (the max |err|)."""
    pairs = [("setup", got.setup.view(torch.int32),
              ref.setup.view(torch.int32))]
    pairs += [(k, getattr(got, k), getattr(ref, k))
              for k in ("blo", "bn", "cmask")]
    for k, a, b in pairs:
        if a.shape != b.shape or not torch.equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else "all"
            raise AssertionError(f"binning {k} differs from the plain "
                                 f"version at {bad} elements ({where})")
    return 0.0


def _head(win, n: int):
    """The windows of the first n images."""
    return type(win)(*(t[:n] for t in win))


def check_raster(name, batch, cfg, assets, rng):
    """A rasterizer kernel against its plain version at `batch` on the
    asset's raster row order, then timed there, with its tests and
    bound. Returns the kernel line's numbers and (windows, records,
    outputs)."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
    kernel, plain, _, rec_fields = _raster_kernels()[name]
    bfm = device_bfm(assets, DEVICE)
    s = cfg.image_size
    kw = dict(height=s, width=s, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              n_faces=assets.n_faces)
    rec, win = _inputs(cfg, bfm, sample_coeffs(rng, cfg, batch))
    # the next 8 faces of the stream are skipped, so that each kernel is
    # timed on the faces of the kernel table's earlier readings
    sample_coeffs(rng, cfg, 8)
    got = kernel(win, rec, **kw)
    torch.cuda.synchronize()
    err = _hold(name, got, plain(win, rec, **kw), "asset order")
    cover = float((got[0] >= 0).float().mean())
    ms = _time_ms(lambda: kernel(win, rec, **kw), reps=20)
    plain_ms = _time_ms(lambda: plain(win, rec, **kw), reps=1, warmup=0)
    print(f"{name} batch={batch} max bn={int(win.bn.max())} "
          f"coverage={cover:.4f} kernel={ms:.4f} ms plain={plain_ms:.2f} ms "
          f"max|err|={err:.3g} (tri_id exact)")
    t = _tests_made(win, cfg.tile_h, cfg.raster_cols, s)
    print(_tests_line(name, t))
    bound_ms, bound_by = _bound(
        _raster_bytes(win, got, rec_fields, cfg.raster_cols, assets.n_faces),
        t["needed_ops"], name)
    del bfm
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err), (win, rec, got)


def check_select_grad(cfg, win, rec, row):
    """K3 on K2's winner rows with a cotangent drawn from a seed: max
    |diff| <= 1e-5 x max |ref|, two launches bitwise equal, fields
    17..23 zero; then its time, the plain version's, one index_add_ of
    the same sums (the plain version's core), a zero fill of its output
    (the least K3 can take) and the bound. Returns the kernel line's
    numbers."""
    from facerecon_tpu_torch.ops import rasterize as R
    bsz, height, width = row.shape
    g = torch.randn((bsz, R._SEL, height, width), device=DEVICE,
                    generator=torch.Generator(DEVICE).manual_seed(5))
    kw = dict(rows=rec.shape[2], tile_h=cfg.tile_h)
    args = (row, g, win.blo, win.bn)
    got = R.select_grad(*args, **kw)
    again = R.select_grad(*args, **kw)
    torch.cuda.synchronize()
    ref = R.select_grad_reference(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("select_grad is not deterministic: two "
                             "launches differ")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not (scale > 0 and err <= 1e-5 * scale and not got[:, 17:].any()):
        raise AssertionError(f"select_grad differs from the plain version "
                             f"by {err} (max |ref| {scale})")
    ms = _time_ms(lambda: R.select_grad(*args, **kw), reps=20)
    plain_ms = _time_ms(lambda: R.select_grad_reference(*args, **kw),
                        reps=1, warmup=0)
    hit = row >= 0
    src = g[:, :R._GRAD].permute(0, 2, 3, 1)[hit].contiguous()
    dst = (row.to(torch.int64) + torch.arange(
        bsz, device=DEVICE)[:, None, None] * kw["rows"])[hit]
    acc = torch.zeros((bsz * kw["rows"], R._GRAD), device=DEVICE)
    library_ms = _time_ms(lambda: acc.index_add_(0, dst, src), reps=20)
    out = torch.empty((bsz, R._FIELDS, kw["rows"]), device=DEVICE)
    fill_ms = _time_ms(out.zero_, reps=20)
    # the cotangent is needed only at covered pixels: a background pixel
    # has no winner row and its g is never read
    n_hit = int(hit.sum())
    bound_ms, bound_by = _bound(
        _nbytes(row, win.blo, win.bn, out) + n_hit * R._GRAD * 4,
        n_hit * R._GRAD, "select_grad")
    print(f"select_grad batch={bsz} rows={kw['rows']} covered px={n_hit} "
          f"kernel={ms:.4f} ms plain={plain_ms:.2f} ms "
          f"index_add_={library_ms:.4f} ms output zero fill={fill_ms:.4f} "
          f"ms bound={bound_ms:.4f} ms max|err|={err:.3g} (max|ref| "
          f"{scale:.3g}; two launches bitwise equal)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, max_abs_err=err)


def _floor_settings(mode: str):
    """The RP_ABLATE settings the floor phase times for FLOOR_KMODE
    `mode`: each phase alone, then the reference's skeleton; K4 (pos)
    has no select, so it skips `sel` in both."""
    from facerecon_tpu_torch.benchmarks import floor_probe as FP
    keep = [p for p in FP.ABLATE if not (mode == "pos" and p == "sel")]
    skeleton = [p for p in FLOOR_SKELETON.split(",")
                if not (mode == "pos" and p == "sel")]
    return keep + [",".join(skeleton)]


def _floor_builds():
    """Every ablated build of K1, K2 and K4 the floor phase times, each
    nvcc (then cuobjdump) started together. Returns {(mode, setting):
    (macros, SASS opcode mix)} and prints each new build's ptxas
    lines."""
    from facerecon_tpu_torch.benchmarks import floor_probe as FP
    from facerecon_tpu_torch.ops import _build
    jobs = {(mode, setting): FP.ablation(setting, mode)
            for mode in FP.MODES for setting in _floor_settings(mode)}

    def build(job):
        name, defines = FP.MODES[job[0]], jobs[job]
        return _build.build((name,), defines), _sass_mix(name, defines)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(build, jobs)))
    print(f"floor ablated builds: {len(jobs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for (mode, setting), (log, _) in done.items():
        for name, text in log.items():
            print(f"  {name} RP_ABLATE={setting}: "
                  f"{'; '.join(_ptxas_lines(text))}")
    return {job: (jobs[job], sass) for job, (_, sass) in done.items()}


def check_floor(cfg, assets):
    """K5: K1, K2 and K4 alone on inputs precomputed once, at
    benchmarks/floor_probe.py's defaults, with the real chunk masks and
    with every mask bit set (every chunk of the first 64 of a window is
    tested; values not checked, only the time). Each kernel's real-mask
    call is first held against its plain version on its first
    FLOOR_CHECK images. Then each ablated build (floor_probe's RP_ABLATE:
    each phase alone and the skeleton) is launched through the twin on
    the real masks and timed beside the full kernel, with its SASS opcode
    mix. It prints the tests the inputs need and the tests the kernels
    issue (_tests_made), and the full kernels' opcode mixes beside the
    ablated builds'."""
    from facerecon_tpu_torch.benchmarks import floor_probe as FP
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
    variants = _floor_builds()
    fcfg = dataclasses.replace(cfg, tile_h=FLOOR_TILE_H,
                               raster_cols=FLOOR_COLS)
    bfm = device_bfm(assets, DEVICE)
    rec, win = _inputs(fcfg, bfm, sample_coeffs(
        np.random.default_rng(0), fcfg, FLOOR_BATCH, scale=0.0))
    ones = win._replace(cmask=torch.full_like(win.cmask, -1))
    sub, sub_rec = _head(win, FLOOR_CHECK), rec[:FLOOR_CHECK]
    s = cfg.image_size
    kw = dict(height=s, width=s, tile_h=fcfg.tile_h, n_cols=fcfg.raster_cols,
              n_faces=assets.n_faces)
    live = int(_popcount(win.cmask).sum())
    added = win.cmask.numel() * 32 - live    # chunks the saturated masks add
    counts = _tests_made(win, fcfg.tile_h, fcfg.raster_cols, s)
    print(_tests_line("floor", counts))
    modes = {name: mode for mode, name in FP.MODES.items()}
    for name, (kernel, plain, _, rec_fields) in _raster_kernels().items():
        got = kernel(win, rec, **kw)
        torch.cuda.synchronize()
        err = _hold(name, tuple(t[:FLOOR_CHECK] for t in got),
                    plain(sub, sub_rec, **kw),
                    f"floor, first {FLOOR_CHECK} images")
        bound_ms, bound_by = _bound(
            _raster_bytes(win, got, rec_fields, fcfg.raster_cols,
                          assets.n_faces), counts["needed_ops"],
            f"floor {name} (real masks)")
        t_real = _time_ms(lambda: kernel(win, rec, **kw), reps=8)
        t_ones = _time_ms(lambda: kernel(ones, rec, **kw), reps=8)
        print(f"floor {name}: batch {FLOOR_BATCH} tile_h {fcfg.tile_h} "
              f"{fcfg.raster_cols} cols frontal, real masks {t_real:.4f} ms "
              f"({live} tested chunks; first {FLOOR_CHECK} images equal to "
              f"the plain version, max|err| {err:.3g}), saturated "
              f"{t_ones:.4f} ms (+{added} chunks): "
              f"{(t_ones - t_real) * 1e6 / added:.3f} ns per chunk added; "
              f"real-mask bound {bound_ms:.4f} ms by {bound_by}; SASS "
              f"opcodes: {_sass_mix(name)}")
        # the ablated builds on the real masks (values not checked here)
        mode = modes[name]
        fkw = dict(size=s, tile_h=fcfg.tile_h, n_cols=fcfg.raster_cols,
                   n_faces=assets.n_faces)
        for setting in _floor_settings(mode):
            defines, sass = variants[(mode, setting)]
            outs = FP.outputs(mode, FLOOR_BATCH, s, DEVICE)
            t = _time_ms(lambda: FP.launch(mode, win, rec, outs,
                                           defines=defines, **fkw), reps=8)
            print(f"floor {name} RP_ABLATE={setting}: {t:.4f} ms against "
                  f"the full kernel's {t_real:.4f} ms ({t - t_real:+.4f} ms, "
                  f"{t / t_real:.3f} of it); SASS opcodes: {sass}")
            del outs
        del got
    del bfm, rec, win, ones, sub, sub_rec
    torch.cuda.empty_cache()


def _ptxas_lines(log: str):
    """The register, stack and spill lines of a kernel's ptxas log."""
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]


def _sass_mix(name: str, defines=()) -> str:
    """The opcode counts of a built kernel's machine code (cuobjdump
    -sass of its library; the variant with `defines` set), most frequent
    first."""
    from facerecon_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return "(no cuobjdump beside nvcc)"
    run = subprocess.run([str(tool), "-sass",
                          str(_build.library_path(name, defines))],
                         capture_output=True, text=True, timeout=120)
    if run.returncode != 0:
        return f"(cuobjdump exited {run.returncode})"
    sass = run.stdout
    ops = collections.Counter(re.findall(
        r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", sass,
        re.M))
    return ", ".join(f"{op} {n}" for op, n in ops.most_common())


def check_ctz_walk():
    """K6 against its plain version at the probe's shape, exactly equal
    for each live-bit count; then timed, and its CTZ_UNROLLED build (the
    probe's looped=0 walk, through the twin benchmarks/ctzloop_probe.walk)
    timed beside it. Returns the kernel line's numbers (at WALK_REPORTED
    live bits; the bound of the per-program walk the probe makes)."""
    from facerecon_tpu_torch.benchmarks import ctzloop_probe
    from facerecon_tpu_torch.ops import probes
    setup, masks = ctzloop_probe.inputs(DEVICE, WALK_PROGS)
    for live, mask in masks.items():
        got = probes.ctz_walk(mask, setup)
        torch.cuda.synchronize()
        ref = probes.ctz_walk_reference(mask, setup)
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"ctz_walk differs from the plain version "
                                 f"at {bad} values ({live} live bits)")
    times = {live: _time_ms(lambda: probes.ctz_walk(mask, setup), reps=20)
             for live, mask in masks.items()}
    for live, ms in times.items():
        print(f"ctz_walk: {WALK_PROGS} programs x {live} live bits "
              f"{ms:.4f} ms, {ms * 1e6 / (WALK_PROGS * live):.3f} ns per "
              f"live chunk (equal to the plain version)")
    for live, mask in masks.items():
        ms = _time_ms(lambda: ctzloop_probe.walk(mask, setup, False),
                      reps=20)
        print(f"ctz_walk CTZ_UNROLLED (looped=0): {WALK_PROGS} programs x "
              f"{live} live bits {ms:.4f} ms, "
              f"{ms * 1e6 / (WALK_PROGS * live):.3f} ns per live chunk, "
              f"{ms / times[live]:.3f} of the __ffs walk's {times[live]:.4f}"
              f" ms")
    print(f"ctz_walk CTZ_UNROLLED SASS opcodes: "
          f"{_sass_mix('ctz_walk', ctzloop_probe.UNROLLED)}")
    mask = masks[WALK_REPORTED]
    plain_ms = _time_ms(lambda: probes.ctz_walk_reference(mask, setup),
                        reps=3)
    # the amin yardstick: one amin over the masked per-chunk minima, the
    # coverage tests precomputed outside the timed call. It is the last
    # step of K6's function, not the function, so the kernel line's
    # library_ms stays null (no single PyTorch call computes K6)
    shift = torch.arange(32, device=DEVICE, dtype=torch.int64)
    on = ((mask.to(torch.int64)[:, None] >> shift) & 1).bool()
    s = setup[:6, :32 * probes.CHUNK].reshape(6, 32, probes.CHUNK)
    p = torch.arange(probes.COL_PX, device=DEVICE,
                     dtype=torch.float32)[:, None, None]
    e0, e1, ez = (s[k] * p + s[k + 1] for k in (0, 2, 4))
    cmin = torch.where((e0 >= 0) & (e1 >= 0) & (e0 + e1 <= 1), ez,
                       float("inf")).amin(dim=2)
    masked = torch.where(on[:, None, :], cmin, float("inf"))
    amin_ms = _time_ms(lambda: masked.amin(dim=2), reps=20)
    print(f"ctz_walk at {WALK_REPORTED} live bits: kernel "
          f"{times[WALK_REPORTED]:.4f} ms, plain version {plain_ms:.4f} ms, "
          f"its final amin alone {amin_ms:.4f} ms")
    out = probes.ctz_walk(mask, setup)
    # the probe's work: each program tests each of its live chunks
    n_tests = WALK_PROGS * WALK_REPORTED * probes.CHUNK * probes.COL_PX
    bound_ms, bound_by = _bound(_nbytes(mask, setup, out),
                                n_tests * WALK_FLOPS,
                                "ctz_walk (per-program walk)")
    # the function alone: each distinct live chunk tested once, its
    # minima shared by the programs (the masked min not counted)
    chunks = int(on.any(dim=0).sum())
    fn_ms, fn_by = _bound(
        _nbytes(mask, out) + chunks * probes.CHUNK * 6 * 4,
        chunks * probes.CHUNK * probes.COL_PX * WALK_FLOPS,
        "ctz_walk (function alone)")
    print(f"ctz_walk bound: per-program walk {bound_ms:.4f} ms by "
          f"{bound_by} (the kernel line's); the function alone, {chunks} "
          f"distinct chunks, {fn_ms:.6f} ms by {fn_by}")
    return dict(ms=times[WALK_REPORTED], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                max_abs_err=0.0)


def _device_ms(run, reps: int) -> dict:
    """Device ms a call of each device op run() launches: reps calls after
    a warm-up, in one torch.profiler pass; op name -> ms, and "all" their
    sum."""
    from torch.profiler import ProfilerActivity, profile
    from facerecon_tpu_torch import profile_trace
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    top = profile_trace.summarize(profile_trace.trace_events(prof),
                                  n_top=100)["top"]
    out = {name: ms / reps for name, _, ms, _ in top}
    out["all"] = sum(out.values())
    return out


def check_binning(cfg, assets):
    """The binning kernels (csrc/binning.cu, through
    ops/rasterize.band_windows) against their plain version at each
    BIN_RUNS shape (the headline's microbatch, render512's) on the
    asset's raster row order: Windows bit for bit (_hold_windows); then
    timed: ms a call (CUDA events), each kernel's device ms (one profiler
    pass, the kernels matched by their ops/_build.SYMBOLS), the plain
    version's ms, and the bytes bound (the padded setup written, the
    vertices read). Returns the kernels line's numbers at the headline's
    shape."""
    from facerecon_tpu_torch import profile_trace
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry, device_bfm
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    bfm = device_bfm(assets, DEVICE)
    result = {}
    for where, size, tile_h, n_cols, batch in BIN_RUNS:
        scfg = dataclasses.replace(cfg, image_size=size,
                                   focal=cfg.focal * size / cfg.image_size,
                                   tile_h=tile_h, raster_cols=n_cols)
        c = split_coeff(torch.as_tensor(sample_coeffs(
            np.random.default_rng(4), scfg, batch), device=DEVICE), scfg)
        vndc = coeffs_to_geometry(c, bfm, scfg).verts_ndc
        args = (vndc, bfm.raster_rows, bfm.raster_row_id, size, size,
                tile_h, n_cols)
        got = R.band_windows(*args)
        torch.cuda.synchronize()
        _hold_windows(got, R.band_windows_reference(*args), where)
        ms = _time_ms(lambda: R.band_windows(*args), 20)
        plain_ms = _time_ms(lambda: R.band_windows_reference(*args), REPS)
        ops = _device_ms(lambda: R.band_windows(*args), 20)
        split = {k: sum(v for name, v in ops.items()
                        if profile_trace._runs(name, _build.SYMBOLS[k]))
                 for k in ("bin_setup", "bin_windows")}
        bound_ms, bound_by = _bound(_nbytes(got.setup, vndc), 0,
                                    f"binning ({where})")
        print(f"binning {where}: batch {batch}, {size} px, tile_h {tile_h} "
              f"x {n_cols} columns, max bn {int(got.bn.max())}, Windows bit "
              f"for bit the plain version's; {ms:.4f} ms a call (bin_setup "
              f"{split['bin_setup']:.4f}, bin_windows "
              f"{split['bin_windows']:.4f} ms device), plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.1f}% of it) on {_card_line()}")
        if where == "headline":
            result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=0.0)
        del vndc, got
    del bfm
    torch.cuda.empty_cache()
    return result


def check_geometry(cfg, assets):
    """The geometry kernel (csrc/geometry.cu, through
    ops/geometry.vertex_pass) at each GEO_RUNS shape on the basis products
    of sample_coeffs faces, held against its plain version run on the
    card, the eager path's forward op for op (shape and texture bit for
    bit, every other field within GEO_ATOL, the landmarks within GEO_ATOL
    relative); timed with CUDA events (the kernel, the whole layer
    through coeffs_to_geometry under no_grad, the plain version), each
    device op's ms, and the bound: the bases read and the six (B, N, 3)
    planes and the landmarks written, and the basis products' FMAs (one
    f32 instruction each). Returns the kernels line's numbers at the
    headline's shape."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops import geometry as G
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    bfm = G.device_bfm(assets, DEVICE)
    result = {}
    for where, size, batch in GEO_RUNS:
        scfg = dataclasses.replace(cfg, image_size=size,
                                   focal=cfg.focal * size / cfg.image_size)
        c = split_coeff(torch.as_tensor(sample_coeffs(
            np.random.default_rng(4), scfg, batch), device=DEVICE), scfg)
        parts = G.basis_products(c, bfm)
        got = G.vertex_pass(parts, c, bfm, scfg)
        torch.cuda.synchronize()
        ref = G.vertex_pass_reference(parts, c, bfm, scfg)
        errs = {}
        for name in G.Geometry._fields:
            a, b = getattr(got, name), getattr(ref, name)
            err = float((a - b).abs().max())
            errs[name] = err
            if name in ("shape", "texture"):
                ok = torch.equal(a, b)
            elif name == "landmarks2d":
                ok = bool(((a - b).abs() <= GEO_ATOL * b.abs()).all())
            else:
                ok = err <= GEO_ATOL
            if not ok:
                raise AssertionError(f"geometry ({where}): {name} differs "
                                     f"from the plain version by {err}")
        print(f"geometry {where}: batch {batch}, {size} px: held against "
              f"the plain version on the card, max |diff| "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        del ref

        def layer():
            with torch.no_grad():
                return G.coeffs_to_geometry(c, bfm, scfg)
        ms = _time_ms(lambda: G.vertex_pass(parts, c, bfm, scfg), 20)
        layer_ms = _time_ms(layer, 20)
        plain_ms = _time_ms(
            lambda: G.vertex_pass_reference(parts, c, bfm, scfg), REPS)
        split = _device_ms(layer, 20)
        named = {k: v for k, v in split.items()
                 if k == "all" or "geometry" in k or "shape_kernel" in k}
        n_fma = batch * parts[0].shape[1] * sum(
            b.shape[1] for b in (bfm.id_basis, bfm.exp_basis,
                                 bfm.tex_basis))
        bound_ms, bound_by = _bound(
            _nbytes(bfm.id_basis, bfm.exp_basis, bfm.tex_basis,
                    *got[:5], got.radiance, got.landmarks2d),
            n_fma, f"geometry ({where})")
        design = _nbytes(bfm.id_basis, bfm.exp_basis, bfm.tex_basis,
                         got.landmarks2d) + 13 * _nbytes(got.shape)
        print(f"geometry {where}: kernel {ms:.4f} ms a call, the layer "
              f"(basis products + kernel) {layer_ms:.4f} ms, device ms "
              + ", ".join(f"{k[:60]} {v:.4f}" for k, v in named.items())
              + f"; plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms by "
              f"{bound_by} ({100 * bound_ms / layer_ms:.1f}% of the layer), "
              f"the design's bytes {design} -> "
              f"{design / H100_BYTES_S * 1e3:.4f} ms on {_card_line()}")
        if where == "headline":
            result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by,
                          max_abs_err=max(errs.values()),
                          library_ms=None)
        del got, parts, c
    del bfm
    torch.cuda.empty_cache()
    return result


def _records_inputs(cfg, assets):
    """Each REC_RUNS path's record inputs on the card: (where, batch,
    size, pack, plain, args), args the pack's; the BFM's from the
    geometry kernel (its vertices and radiance), DECA's from TEX_CELL's
    configuration and TEX_BATCH codes of its sampler (FLAME's vertices
    and world normals)."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops import flame as FL
    from facerecon_tpu_torch.ops import render as RE
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry, device_bfm
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    from facerecon_tpu_torch.utils.flame import flame_assets
    from perfbench import spec
    from perfbench.kinds import flame_render as FR
    bfm = device_bfm(assets, DEVICE)
    pad = R.padded_rows(bfm.raster_rows.shape[0])
    for where, size, batch in REC_RUNS:
        scfg = dataclasses.replace(cfg, image_size=size,
                                   focal=cfg.focal * size / cfg.image_size)
        c = split_coeff(torch.as_tensor(sample_coeffs(
            np.random.default_rng(4), scfg, batch), device=DEVICE), scfg)
        with torch.no_grad():
            geom = coeffs_to_geometry(c, bfm, scfg)
        yield (where, batch, size, RE.pack_render_records,
               RE.pack_render_records_reference,
               (geom.verts_ndc, geom.radiance, bfm.raster_rows, size, size,
                pad))
        del geom, c
    del bfm
    cfgf = spec.cell(TEX_CELL)["config_file"]
    dcfg = FR.port_config(cfgf, TEX_BATCH)
    s = dcfg.image_size
    dfl = FL.device_flame(flame_assets(FR.arrays(cfgf), s), DEVICE,
                          dcfg.n_tex, dcfg.uv_size)
    codes = torch.from_numpy(FR.sample_codes(np.random.default_rng(
        TEX_SEED), cfgf["sizes"], TEX_BATCH)).to(DEVICE)
    with torch.no_grad():
        geo = FL.flame_geometry(split_coeff(codes, dcfg), dfl, dcfg,
                                image_size=s)
    yield (TEX_CELL, TEX_BATCH, s, RE.pack_texture_records,
           RE.pack_texture_records_reference,
           (geo.verts_ndc, geo.normals, dfl, s, s,
            R.padded_rows(dfl.raster_rows.shape[0])))


def check_records(cfg, assets):
    """The record kernel (csrc/records.cu, through
    ops/render.pack_render_records and pack_texture_records) at each
    REC_RUNS shape and at DECA's cell: held once against the plain
    version (the eager pack) on the inputs it is timed on, as int32 bits
    over every field and padded row; then timed with CUDA events beside
    the plain version, and bounded by the record written and the two
    (B, N, 3) planes read. Returns the kernels line's numbers at the
    headline's shape."""
    result = {}
    for where, batch, size, pack, plain, args in _records_inputs(cfg,
                                                                 assets):
        with torch.no_grad():
            got = pack(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                bad = int((got.view(torch.int32)
                           != want.view(torch.int32)).sum())
                raise AssertionError(f"records ({where}): {bad} words differ "
                                     f"from the plain version")
            del want
            ms = _time_ms(lambda: pack(*args), 20)
            plain_ms = _time_ms(lambda: plain(*args), REPS)
        bound_ms, bound_by = _bound(_nbytes(got, args[0], args[1]), 0,
                                    f"records ({where})")
        print(f"records {where}: batch {batch}, {size} px, "
              f"{got.shape[2]} padded rows, bit for bit the plain version; "
              f"{ms:.4f} ms a call, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.1f}% of it) on {_card_line()}")
        if where == "headline":
            result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=0.0,
                          library_ms=None)
        del got, args
    torch.cuda.empty_cache()
    return result


def check_texture():
    """DECA's textured kernel on TEX_CELL's inputs: the configuration's
    FLAME stand-ins and TEX_BATCH codes from the cell's sampler, through
    the path's own functions (FLAME's geometry, the albedo decode, the
    textured records, the binning); held against
    texture_windows_reference (tri_id exact, colour and barycentrics
    within 1e-6, coverage above 0.3), then timed beside the plain
    version's one call, and bounded by perfbench/work_flame.texture_work
    on the same codes. Returns the kernels line's numbers."""
    from facerecon_tpu_torch.ops import flame as FL
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.render import pack_texture_records
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    from facerecon_tpu_torch.utils.flame import flame_assets
    from perfbench import spec, work_flame
    from perfbench.kinds import flame_render as FR
    from perfbench.reference import deca
    cfgf = spec.cell(TEX_CELL)["config_file"]
    cfg = FR.port_config(cfgf, TEX_BATCH)
    arrays = FR.arrays(cfgf)
    s = cfg.image_size
    dfl = FL.device_flame(flame_assets(arrays, s), DEVICE, cfg.n_tex,
                          cfg.uv_size)
    codes = torch.from_numpy(FR.sample_codes(np.random.default_rng(
        TEX_SEED), cfgf["sizes"], TEX_BATCH)).to(DEVICE)
    c = split_coeff(codes, cfg)
    with torch.no_grad():
        geo = FL.flame_geometry(c, dfl, cfg, image_size=s)
        rec = pack_texture_records(geo.verts_ndc, geo.normals, dfl, s, s,
                                   R.padded_rows(dfl.raster_rows.shape[0]))
        win = R.band_windows(geo.verts_ndc, dfl.raster_rows,
                             dfl.raster_row_id, s, s, cfg.tile_h,
                             cfg.raster_cols)
        args = (win, rec, FL.decode_albedo(c.tex, dfl),
                c.light.reshape(-1, 9, 3).contiguous(), dfl.sh_factor)
    kw = dict(height=s, width=s, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              n_faces=dfl.faces.shape[0])
    got = R.texture_windows(*args, **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = R.texture_windows_reference(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    if not torch.equal(got[0], ref[0]):
        bad = int((got[0] != ref[0]).sum())
        raise AssertionError(f"raster_texture tri_id differs from the plain "
                             f"version at {bad} pixels")
    err = max(float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:]))
    if not err <= 1e-6:
        raise AssertionError(f"raster_texture colour/bary differ from the "
                             f"plain version by {err}")
    cover = float((got[0] >= 0).float().mean())
    if not cover > 0.3:
        raise AssertionError(f"raster_texture covers {cover} of the pixels")
    del got, ref
    ms = _time_ms(lambda: R.texture_windows(*args, **kw), reps=20)
    with torch.no_grad():
        n_bytes, n_ops = work_flame.texture_work(
            codes, deca.flame_on(arrays, DEVICE), s, cfg.uv_size)
    bound_ms, bound_by = _bound(n_bytes, n_ops, "raster_texture")
    print(f"raster_texture[{TEX_CELL}] batch={TEX_BATCH} {s} px tile_h "
          f"{cfg.tile_h} x {cfg.raster_cols} columns coverage={cover:.4f} "
          f"kernel={ms:.4f} ms plain={plain_ms:.2f} ms bound={bound_ms:.4f} "
          f"ms ({bound_by}) max|err|={err:.3g} (tri_id exact) on "
          f"{_card_line()}")
    del args, win, rec, geo, dfl, codes
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


def _detail_inputs():
    """DETAIL_CELL's kind set up at DETAIL_SEED (the configuration's
    FLAME and detail stand-ins, the decoder's seeded, calibrated weights,
    the cell's codes), and the first TEX_BATCH codes through the path's
    own functions up to the UV detail pass: (kind, codes, the pass's
    arguments)."""
    from facerecon_tpu_torch.models.deca_detail import decoder_input
    from facerecon_tpu_torch.ops import flame as FL
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    from perfbench import spec
    from perfbench.kinds import flame_detail as FD
    kind = FD.Kind(spec.cell(DETAIL_CELL), DETAIL_SEED,
                   torch.device(DEVICE))
    kind.setup()
    pack, s = kind.flame, kind.uv_size
    codes = kind.codes[:TEX_BATCH]
    c = split_coeff(codes, kind.cfg)
    with torch.no_grad():
        geo = FL.flame_geometry(c, pack, kind.cfg, image_size=kind.size)
        uv_z = pack.detail.decoder(decoder_input(c)).view(-1, s, s)
        args = (geo.verts_world, geo.normals, uv_z, pack.detail,
                FL.decode_albedo(c.tex, pack),
                c.light.reshape(-1, 9, 3).contiguous(), pack.sh_factor)
    return kind, codes, geo, args


def _launched_alone(name):
    """Fails unless the launch counters, zeroed just before the call,
    read one launch of `name` and none of any other port kernel."""
    from facerecon_tpu_torch.ops import _build
    want = {k: int(k == name) for k in _build.KERNELS}
    if _build.LAUNCHES != want:
        raise AssertionError(f"{name}: launches {dict(_build.LAUNCHES)}")


def _plain_ms(fn):
    """(fn(), its ms by CUDA events): one call of a plain version."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_uv_detail(kind, args):
    """The UV detail kernel (csrc/uv_detail.cu, through
    ops/detail.uv_detail) on DETAIL_CELL's inputs at its microbatch
    (5,023 vertices, 256^2 maps): one launch, held against
    uv_detail_reference (the displacement map bit for bit, the texture
    and the detail normals within 1e-6), then timed beside the plain
    version's one call, and bounded by perfbench/work_detail
    .uv_detail_bytes. Returns (the kernels line's numbers, uv_texture)."""
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import detail as DT
    from perfbench import work_detail
    _build.reset_launches()
    got = DT.uv_detail(*args)
    torch.cuda.synchronize()
    _launched_alone("uv_detail")
    ref, plain_ms = _plain_ms(lambda: DT.uv_detail_reference(*args))
    if not torch.equal(got[2], ref[2]):
        bad = int((got[2] != ref[2]).sum())
        raise AssertionError(f"uv_detail displacement map differs from the "
                             f"plain version at {bad} texels")
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], ref[:2]))
    if not err <= 1e-6:
        raise AssertionError(f"uv_detail texture/normals differ from the "
                             f"plain version by {err}")
    del ref
    ms = _time_ms(lambda: DT.uv_detail(*args), reps=20)
    bsz, n = args[0].shape[:2]
    bound_ms, bound_by = _bound(work_detail.uv_detail_bytes(
        bsz, n, kind.uv_size), 0, "uv_detail")
    print(f"uv_detail[{DETAIL_CELL}] batch={bsz} {n} vertices "
          f"{kind.uv_size}^2 maps kernel={ms:.4f} ms plain={plain_ms:.2f} ms "
          f"bound={bound_ms:.4f} ms ({bound_by}) max|err|={err:.3g} "
          f"(displacement exact) on {_card_line()}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err), got[0]


def check_texfetch(kind, codes, geo, texture):
    """The detailed image's fetch (raster_texfetch_kernel in
    csrc/raster_texture.cu, through ops/rasterize.texfetch_windows) on
    DETAIL_CELL's inputs at its microbatch (224 px, tile_h 4 x 7
    columns, FLAME's 9,976 faces, the UV detail kernel's 256^2
    uv_texture): one launch, held against texfetch_windows_reference
    (tri_id exact, colour and barycentrics within 1e-6, coverage above
    0.3), then timed beside the plain version's one call, and bounded by
    perfbench/work_detail.texfetch_work on the same codes. Returns the
    kernels line's numbers."""
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.render import pack_texture_records
    from perfbench import work_detail
    pack, cfg, s = kind.flame, kind.cfg, kind.size
    with torch.no_grad():
        rec = pack_texture_records(geo.verts_ndc, geo.normals, pack, s, s,
                                   R.padded_rows(pack.raster_rows.shape[0]))
        win = R.band_windows(geo.verts_ndc, pack.raster_rows,
                             pack.raster_row_id, s, s, cfg.tile_h,
                             cfg.raster_cols)
    kw = dict(height=s, width=s, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              n_faces=pack.faces.shape[0])
    _build.reset_launches()
    got = R.texfetch_windows(win, rec, texture, **kw)
    torch.cuda.synchronize()
    _launched_alone("raster_texfetch")
    ref, plain_ms = _plain_ms(lambda: R.texfetch_windows_reference(
        win, rec, texture, **kw))
    if not torch.equal(got[0], ref[0]):
        bad = int((got[0] != ref[0]).sum())
        raise AssertionError(f"raster_texfetch tri_id differs from the "
                             f"plain version at {bad} pixels")
    err = max(float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:]))
    if not err <= 1e-6:
        raise AssertionError(f"raster_texfetch colour/bary differ from the "
                             f"plain version by {err}")
    cover = float((got[0] >= 0).float().mean())
    if not cover > 0.3:
        raise AssertionError(f"raster_texfetch covers {cover} of the pixels")
    del got, ref
    ms = _time_ms(lambda: R.texfetch_windows(win, rec, texture, **kw),
                  reps=20)
    with torch.no_grad():
        n_bytes, n_ops = work_detail.texfetch_work(codes, kind.fl, s,
                                                   kind.uv_size)
    bound_ms, bound_by = _bound(n_bytes, n_ops, "raster_texfetch")
    print(f"raster_texfetch[{DETAIL_CELL}] batch={codes.shape[0]} {s} px "
          f"tile_h {cfg.tile_h} x {cfg.raster_cols} columns "
          f"coverage={cover:.4f} kernel={ms:.4f} ms plain={plain_ms:.2f} ms "
          f"bound={bound_ms:.4f} ms ({bound_by}) max|err|={err:.3g} "
          f"(tri_id exact) on {_card_line()}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


def _channels_last_decoder(dec, z):
    """The eager decoder on channels_last tensors (the yardstick
    library_ms; the port never calls it): the linear layer's NHWC output,
    then each layer's plain version, whose NHWC tensors take cuDNN's
    NHWC convolutions in TF32."""
    from facerecon_tpu_torch.models import deca_detail as MD
    s = dec.init_size
    x = dec.l1(z).view(z.shape[0], s, s, MD.CHANNELS[0])
    for w, b in zip(dec.conv_w, dec.conv_b):
        x = MD.upconv_reference(x, w, b)
    return MD.outconv_reference(x, dec.out_w, dec.out_b)


def check_decoder(kind, codes):
    """The detail decoder's kernels (csrc/upconv.cu, through the pack's
    folded decoder) on DETAIL_CELL's decoder and codes at its microbatch:
    the linear layer, 5 upconv and 1 outconv launches and no other port
    kernel, its largest gap to the reference's float32 decoder (TF32 off)
    at most twice the plain version's (the eager NCHW decoder, cuDNN in
    TF32), then timed beside the plain version's one call and the eager
    decoder on channels_last tensors, and bounded by
    perfbench/work_decoder (the layers after the linear one). Returns
    the kernels line's numbers."""
    from facerecon_tpu_torch.models.deca_detail import decoder_input
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    from perfbench import work_decoder
    dec = kind.flame.detail.decoder
    z = decoder_input(split_coeff(codes, kind.cfg))
    with torch.no_grad():
        _build.reset_launches()
        got = dec(z)
        torch.cuda.synchronize()
        want = {k: 0 for k in _build.KERNELS} | {"upconv": 5, "outconv": 1}
        if _build.LAUNCHES != want:
            raise AssertionError(f"decoder: launches {dict(_build.LAUNCHES)}")
        ref, plain_ms = _plain_ms(lambda: dec.forward_reference(z))
        torch.backends.cudnn.allow_tf32 = False
        f32 = kind.det.generator(z)
        err, ref_err = (float((a - f32).abs().max()) for a in (got, ref))
        del ref, f32
        if not err <= 2 * ref_err:
            raise AssertionError(f"decoder: gap to float32 {err}, twice "
                                 f"the eager TF32 decoder's {ref_err}")
        ms = _time_ms(lambda: dec(z), reps=20)
        library_ms = _time_ms(lambda: _channels_last_decoder(dec, z), reps=5)
    bound_ms = 1e3 * work_decoder.least_seconds(kind.cfgf, z.shape[0])
    print(f"decoder[{DETAIL_CELL}] batch={z.shape[0]} "
          f"{kind.uv_size}^2 maps kernels={ms:.4f} ms "
          f"plain={plain_ms:.2f} ms channels_last={library_ms:.3f} ms "
          f"bound={bound_ms:.4f} ms (TF32 FLOPs or bytes by layer) "
          f"max|err| to float32={err:.3g} (eager TF32 {ref_err:.3g}) on "
          f"{_card_line()}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="flops and bytes by layer", max_abs_err=err,
                library_ms=library_ms)


def check_detail():
    """The detail cell's kernels on one set of its inputs: the decoder's,
    the UV detail kernel, then the fetch of the texture it shaded."""
    kind, codes, geo, args = _detail_inputs()
    dec = check_decoder(kind, codes)
    uv, texture = check_uv_detail(kind, args)
    fetch = check_texfetch(kind, codes, geo, texture)
    kind.free()
    del kind, codes, geo, args, texture
    torch.cuda.empty_cache()
    return dec, uv, fetch


def _probe_cases(name, cases, inner, reps, t0, card):
    """Fails on a non-finite or non-positive time or a non-finite sum;
    prints the twin's summary line."""
    for c in cases:
        if not (np.isfinite([c.seconds, c.first, c.last]).all()
                and c.seconds > 0):
            raise AssertionError(f"{name} {c.tag!r}: non-finite result {c}")
    print(f"probe {name}: {len(cases)} cases at the reference's defaults, "
          f"inner {inner} and reps {reps} (none lowered), "
          f"{time.perf_counter() - t0:.1f} s on {card}")


def check_bench_probes():
    """The probes' twins (facerecon_tpu_torch/benchmarks/, twins of
    benchmarks/calib_probe, roofline_probe, cnn_probe, cnn_micro_probe,
    gather_probe and scatter_probe) through their own functions at the
    reference's defaults, each printing its case lines. Fails on a
    non-finite time or sum, and on any launch of a port kernel in the
    phase (counters reset just before, read just after)."""
    from facerecon_tpu_torch.benchmarks import (calib_probe, cnn_micro_probe,
                                                cnn_probe, gather_probe,
                                                roofline_probe, scatter_probe)
    from facerecon_tpu_torch.ops import _build
    card = _card_line()
    _build.reset_launches()

    t0 = time.perf_counter()
    cases = calib_probe.run(*calib_probe.make_inputs(
        calib_probe.knobs()["batch"], DEVICE))
    _probe_cases("calib_probe", cases, calib_probe.INNER,
                 calib_probe.REPS, t0, card)

    t0 = time.perf_counter()
    big, a, b = roofline_probe.make_inputs(DEVICE)
    cases = roofline_probe.run(big, a, b)
    del big, a, b
    torch.cuda.empty_cache()
    _probe_cases("roofline_probe", cases, roofline_probe.INNER,
                 roofline_probe.REPS, t0, card)

    t0 = time.perf_counter()
    k = cnn_probe.knobs()
    model, images = cnn_probe.model_and_images(k["batch"], DEVICE,
                                               k["dtype"], k["wdtype"])
    cases = cnn_probe.run(model, images, k["inner"], k["reps"])
    del model, images
    torch.cuda.empty_cache()
    _probe_cases("cnn_probe", cases, k["inner"], k["reps"], t0, card)

    t0 = time.perf_counter()
    d = cnn_micro_probe.make_inputs(cnn_micro_probe.knobs()["batch"], DEVICE)
    cases = cnn_micro_probe.run(d)
    del d
    torch.cuda.empty_cache()
    _probe_cases("cnn_micro_probe", cases, cnn_micro_probe.INNER,
                 cnn_micro_probe.REPS, t0, card)

    t0 = time.perf_counter()
    d = gather_probe.make_inputs(gather_probe.knobs()["batch"], DEVICE)
    cases = gather_probe.run(d)
    del d
    torch.cuda.empty_cache()
    _probe_cases("gather_probe", cases, gather_probe.INNER,
                 gather_probe.REPS, t0, card)

    t0 = time.perf_counter()
    k = scatter_probe.knobs()
    idx, zb, ids = scatter_probe.make_inputs(k["batch"], k["m"], k["size"],
                                             DEVICE)
    cases = scatter_probe.run(idx, zb, ids, k["size"], k["batch"])
    del idx, zb, ids
    torch.cuda.empty_cache()
    _probe_cases("scatter_probe", cases, scatter_probe.INNER,
                 scatter_probe.REPS, t0, card)

    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"the probes launched port kernels: {launches}")


def _timed(name, fn, *args):
    """fn(*args), its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from facerecon_tpu_torch.config import default_config
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.utils.bfm import synthetic_bfm

    start = time.perf_counter()
    card = _card_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in _ptxas_lines(log):
            print(f"  {name}: {line}")
        print(f"  {name} SASS opcodes: {_sass_mix(name)}")

    cfg = default_config()
    assets = synthetic_bfm(cfg, 0)
    print(f"config: {cfg.image_size} px, {assets.n_vertices} vertices, "
          f"{assets.n_faces} faces, {assets.raster_rows.shape[0]} raster "
          f"rows, tile_h {cfg.tile_h}, {cfg.raster_cols} columns")
    rng = np.random.default_rng(0)
    measured = {"raster_shade": check_raster("raster_shade", MICRO, cfg,
                                             assets, rng)[0]}
    measured["raster_select"], (win, rec, (_, row, _)) = check_raster(
        "raster_select", TRAIN_BATCH, cfg, assets, rng)
    measured["select_grad"] = check_select_grad(cfg, win, rec, row)
    del win, rec, row
    torch.cuda.empty_cache()
    measured["raster_pos"] = check_raster("raster_pos", MICRO, cfg, assets,
                                          rng)[0]
    measured["binning"] = _timed("binning", check_binning, cfg, assets)
    measured["geometry"] = _timed("geometry", check_geometry, cfg, assets)
    measured["records"] = _timed("records", check_records, cfg, assets)
    measured["raster_texture"] = _timed("texture", check_texture)
    (measured["upconv"], measured["uv_detail"],
     measured["raster_texfetch"]) = _timed("detail", check_detail)
    _timed("floor", check_floor, cfg, assets)
    measured["ctz_walk"] = _timed("ctz_walk", check_ctz_walk)
    _timed("probes", check_bench_probes)

    # what each kernel replaces: the Pallas kernel body, file:line
    replaces = {
        "raster_shade": "facerecon_tpu/ops/rasterize_pallas.py:133",
        "raster_select": "facerecon_tpu/ops/rasterize_pallas.py:133",
        "select_grad": "facerecon_tpu/ops/rasterize_pallas.py:1109",
        "raster_pos": "facerecon_tpu/ops/rasterize_pallas.py:133",
        "ctz_walk": "benchmarks/ctzloop_probe.py:48",
        "raster_texture": "none (the JAX package has no DECA/FLAME path)",
        "binning": "none (XLA-fused jnp: facerecon_tpu/ops/binning.py:228)",
        "geometry": "none (XLA-fused jnp: facerecon_tpu/ops/geometry.py "
                    "coeffs_to_geometry, facerecon_tpu/ops/sh.py illuminate)",
        "records": "none (XLA-fused jnp: facerecon_tpu/ops/render.py "
                   "_render_fields, _stack24)",
        "uv_detail": "none (the JAX package has no DECA detail path)",
        "raster_texfetch": "none (the JAX package has no DECA detail "
                           "path)",
        "upconv": "none (the JAX package has no DECA detail path; the row "
                  "is the decoder: 5 upconv + 1 outconv launches)"}
    kernels = [dict(
        name=name, route="cuda",
        source="facerecon_tpu_torch/csrc/"
               f"{_build.SOURCES.get(name, name)}.cu",
        replaces=replaces[name],
        max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
        bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=m.get("library_ms")) for name, m in measured.items()]
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
