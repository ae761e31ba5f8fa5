#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (facerecon_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit; TF32 off.
  2. build: compiles every kernel of the port from csrc/ with nvcc, and
     prints each one's ptxas registers and spills and the opcode mix of
     its machine code (cuobjdump).
  3. kernels: each kernel against its plain PyTorch version at full width
     (default config: 224 px, synthetic BFM with 70,688 faces). The
     rasterizers K1 (raster_shade) and K2 (raster_select) on the asset's
     raster row order at the main path's batch and on a shuffled row
     order (windows beyond the 64-chunk mask); K3 (select_grad) on K2's
     winner rows with a cotangent drawn from a seed, twice (bitwise
     deterministic), at batch 128 and again on the shuffled order's rows
     plus a near-camera image (rows of more than 128 px over several
     bands); K4 (raster_pos) on both row orders as K1 and K2 (tri_id,
     depth and winner row exactly equal); K1, K2 and K4 on a wide band
     (tile_h 8 x one 224-px column), each held and timed there; then
     the band sweep: K1, K2 and K4 held at full width on bands
     of 1, 2, 4, 8, 64 and 136 rows, on a shuffled order, on saturated
     masks and with cull_backfaces. Times each kernel and its plain
     version; the ops bounds of K1, K2 and K4 count what the inputs need,
     the same for any design (the pixel centers in each triangle's
     bounding box, 7 adds a test, plus the products each of its pixel
     columns and rows shares), printed beside the earlier group-based
     count and the tests the kernels issue
     (ops/rasterize.tests_issued); their bytes bounds what they must read
     (the walked setup chunks, the winners' record sectors). Then the
     binning kernels (csrc/binning.cu: bin_setup, bin_windows, through
     ops/rasterize.band_windows) at the headline's shape (224 px, tile_h
     4 x 7 columns, batch 128) and render512's (512 px, tile_h 2 x 8,
     batch 32) on both row orders: Windows bit for bit the plain
     version's, one launch of each a call; timed (ms a call, each
     kernel's device ms) beside the plain version and the bytes bound
     (the padded setup written, the vertices read). Then DECA's
     textured kernel (csrc/raster_texture.cu) on the path of the
     benchmark cell deca-render224.b512: its configuration's seeded
     FLAME stand-ins, 256 codes (the cell's microbatch; the cell's
     sampler, seed TEX_SEED) at 224 px, tile_h 4 x 7 columns, through
     render_coeffs(inference=True) with the counters reset after a
     warm-up call: one raster_texture launch and one of each binning
     kernel a call, nothing else; the path's first textured call held
     against texture_windows_reference (tri_id exact, colour and
     barycentrics within 1e-6) and its binning bit for bit; then timed
     (ms a launch beside the plain version's one call), and its bound
     from the same codes (perfbench/work_flame.texture_work: the bytes
     read and written once, the distinct albedo texels the covered
     pixels' bilinear footprints read, and the tests the inputs need).
     Then the geometry kernel (csrc/geometry.cu, through
     ops/geometry.vertex_pass) at the headline's microbatch (224 px,
     batch 128) and render512's (512 px, batch 32) on the basis products
     of sample_coeffs faces: one launch a call and nothing else, held
     against its plain version on the card (shape and texture bit for
     bit, the rest within GEO_ATOL, the landmarks within GEO_ATOL
     relative); timed with CUDA events (the kernel, the whole layer
     through coeffs_to_geometry under no_grad, the plain version: the
     eager forward op for op), each pass's device ms,
     and its bound (the bases read and the six planes written; the basis
     products' FMAs).
  4. inference main path: Pipeline.reconstruct with the bf16 ResNet-50.
     A checked small batch of a random-weight model (finite outputs,
     coverage, one K1 launch per call, agreement with the same float32
     pipeline run on the CPU), its stage split (device ms of each of the
     port's spans, one profiler pass) and one timed run of it
     (the inference figure's earlier workload); then the benchmark's
     headline (facerecon_tpu_torch.bench.headline: the BN model's
     initial state, zero head, folded, images from default_rng(0), batch
     256 in microbatches of 128, 1 + 10 x 8 passes) with the launch
     counters reset just before and read just after: one K1 launch, one
     geometry launch and one of each binning kernel a call, nothing else, every
     coefficient 0; its first K1 and binning calls held against their
     plain versions, K1 timed and bounded; its JSON line; its stage
     split.
  5. training main path: the BatchNorm ResNet-50 in bf16, 224 px, batch
     128, random images and landmarks: a stage split (the port's spans,
     the backward cut at fr.coeff_grad) and 10 steps on one
     rendered batch of 8, whose loss must fall; then the benchmark's
     train mode (bench.train: 1 warm-up and 5 timed steps) with the
     counters reset just before and read just after (one K2 and one K3
     launch a step, a finite last loss), its first K2 and K3 calls held
     against their plain versions, and its JSON line.
  6. the §9.5 contract path (rasterize_batch, K4 + decode) at 224 px,
     seeds 7 and 8, batch 4, on the asset row order and the identity
     order: K4 first held against its plain version on each order's
     windows (exactly equal), then the calls, one K4 launch each,
     counters reset just before and read just after, against the native
     oracle (tests/test_tpu_parity.py's bar: tri_id mismatches <= 5e-5
     of covered pixels, none but depth ties; where tri_id agrees, bary
     and zbuf within stated bounds, and zbuf within a bound of the exact
     float64 depth); then evaluate.run at full scale (vertex MAE < 1e-3).
  7. K5 (floor): K1, K2 and K4 alone on inputs precomputed once at
     benchmarks/floor_probe.py's defaults (batch 128, tile_h 2, 4 columns,
     frontal coefficients), each real-mask call held against its plain
     version on its first 32 images, then timed with the real chunk masks
     and with every bit set: ms per launch and the cost of each tested
     chunk added. Then the ablated builds of each (the reference's
     RP_ABLATE through the twin facerecon_tpu_torch/benchmarks/
     floor_probe.py: dma, eval, sel, pack, cull and merge alone, and the
     skeleton sel,eval,dma,pack; K4 has no sel), all built together, each
     launched on the real masks into sentinel-filled outputs and timed
     beside the full kernel with its SASS opcode mix. Values are not
     checked, except where the function is known: cull alone equals the
     full kernel bit for bit, eval alone gives background everywhere,
     pack alone leaves the outputs untouched. The phase prints its wall
     time.
  8. K6 (ctz_walk): the live-chunk walk probe against its plain version
     at benchmarks/ctzloop_probe.py's shape (2,048 programs, 4/8/16/32
     live bits), exactly equal, then timed (counters reset just before):
     ns per live chunk; its bound is that of the per-program walk the
     probe makes, with the function's own bound printed beside it. The
     probe's other walk (looped=0: each bit tested in turn, the
     CTZ_UNROLLED build, through the twin benchmarks/ctzloop_probe.py)
     is held exactly for each live count and timed after the counted
     run, beside the __ffs walk.
  9. the fit driver (fit.make_fit_fn, batch 8 synthetic targets, 50
     Adam steps, landmarks on): the counted, timed fit (one K2 and one K3
     launch a step, one more K2 and one geometry launch for the final
     loss under no_grad; the loss falls), then
     fit.run on a PNG folder of the 8 faces, whose meshes load back.
 10. the train driver on a folder of 64 rendered PNGs, each warped by a
     random similarity, with 68-point side-cars: --data-dir --align 68pt
     --batch 32 --chunk 2 --steps 4 --ckpt-dir (cfg.checkpoint_every 2),
     counted (one K2 and one K3 launch a step); a fresh trainer restored
     from the checkpoint equals it bit for bit; --resume --steps 2 goes
     on to step 6 with finite losses; then ms a step on the uint8 and
     float32 wires.
 11. the infer driver on 4 synthetic faces from a crafted checkpoint
     (perturbed BatchNorm statistics), BN and --fused, --overlay
     --depth: every output file, one K1 and one K2 launch a run (and two
     geometry launches: the synthetic render and the reconstruct), the
     fused coefficients within FUSED_BF16 of the BN-eval ones, finite
     landmark RMSE.
     In phases 9-11 the kernel wrappers record the arguments of their
     first call on the driver's path, and each kernel is held against
     its plain version on those arguments after the counts are read
     (K1 and K2 as in phase 3, K3 within 1e-5 x max |ref| and bitwise
     over two launches). The phases
     (and 12-19) write under one tempfile.mkdtemp(), removed at the end,
     and each prints its launch counts above the kernels line.
 12. the track driver (track.run) at full width: joint on the synthetic
     sequence (16 frames, 100 refine steps: K1 twice, K2 101, K3 100
     launches, geometry 4: the no_grad renders and the ground truth's
     geometry; the loss falls), --sequential (8 frames x 25 steps at
     batch 1, with the device's busy share) and --video (a 16-frame MJPG
     clip written with cv2, decoded within 0.03 of its source, --align
     none; the loss halves), each holding its own first K1/K2/K3 calls
     as in phases 9-11.
 13. config 5's render at 512 px (bench.render512: tile_h 2 x 8
     columns, batch 256 in microbatches of 32, one K1 and one geometry
     launch each, 1 + 5 passes), the first microbatch's K1 and binning
     calls held whole (all 32 images), its JSON line, then K1's ms a
     launch.
 14. the render-chain benchmark (render_bench, the twin of
     benchmarks/render_bench.py) through its own functions at batch 64:
     224 px (tile_h 2 x 7 columns) fwd and fwd+bwd, 512 px (tile_h 1 x 7
     columns of 80 px) fwd+bwd, reps and inner lowered to 1 and 2: each
     run's launches exactly (1 + 3 reps) x inner K2 and as many K3 with
     --bwd, or as many geometry launches without (the forward is under
     no_grad), finite sums, its first K2 and K3 calls held whole against
     their plain versions (K3 also bitwise over two launches), ms a batch,
     K2 and K3 timed a launch on those calls, K2's tests made and issued
     and its bound, the peak of allocated memory.
 15. the rasterizer benchmark (raster_bench, the twin of
     benchmarks/raster_bench.py) at batch 64, tile_h 8 x one 224-px
     column, the asset's own face order, without and with --cull: 1 + 3
     x 5 K4 launches each, the first K4 call held whole (exact), ms a
     batch and K4's ms a launch; then --check (mismatch 0, one launch).
     Phases 14 and 15 print their launches on lines of their own.
 16. the probes' twins (facerecon_tpu_torch/benchmarks/: calib_probe,
     roofline_probe, cnn_probe, cnn_micro_probe, gather_probe and
     scatter_probe, twins of benchmarks/<the same>.py) through their own
     functions at the reference's defaults, each printing its case lines
     and the card: the chained timer's intercept, the card's copy and
     bf16 matmul rates beside the data sheet's, the fused CNN's stage
     deltas at batch 64, the stem forms, the gather forms, the
     scatter-min, the element gather and the sort. The counters reset
     just before and read just after: no port kernel launched. The s2d
     and native stems agree (bf16 within 2^-6 x max |ref|, f32 within
     1e-5), the reference's two pool forms differ, the 1-pass scatter-min
     of the first image equals numpy's minimum.at, and each gather form
     on the first image equals its CPU result.
 17. graft_entry.entry() (the twin of __graft_entry__.entry): one K2
     launch, the reference test's shapes, finite outputs, K2 held.
 18. trace: the trace endpoint (profile_trace, the twin of
     benchmarks/profile_trace.py) through its main() at its defaults
     (batch 32) and through trace() at batch 128, 3 traced calls each
     (K2 and the geometry kernel launched 1 + 3 times, 3 device events of
     each in trace.json, the warm-up call's K2 held), one headline
     microbatch of 128 (one K1 and one geometry device event) and one
     train step at batch 128 (one K2 and one K3 device event), each
     after a warm-up; each trace read through
     profile_trace.summarize: the device's busy share (the union of its
     kernels and copies over the window from the first host op to the
     last device event), its 10 device ops with the most time and its 5
     longest idle gaps with the host op open as each began. The phase
     prints its launches on a line of its own. The busy shares of
     phases 9, 10 and 12 come from the same summary and fail on a trace
     with no device event.
 19. data parallelism at world size 1 (one card): dryrun_multichip(1)
     over NCCL, then two train steps (batch 32) in a world-size-1 NCCL
     group, bit for bit equal to the same steps with no group.
 20. prints the per-kernel JSON line, the card line, and as the last line
     {"ok": true, "device": {...}}.
Weights come from a seed (the benchmark's modes: the reference's
initialisation) and images from a seed.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import unittest.mock
from pathlib import Path

import numpy as np
import torch

MICRO = 128          # inference main-path microbatch
BATCH = 256          # images per timed inference step
REPS = 5             # timed steps (training, render512, kernels)
TRAIN_BATCH = 128    # training main-path batch (bench.py's train mode)
TRAIN_CHUNK = 1      # steps a timed iteration (bench.py's BENCH_CHUNK)
HEAD_REPS = 10       # headline: timed reps of HEAD_INNER_REPS passes each
HEAD_INNER_REPS = 8  # (bench.py's BENCH_REPS and BENCH_INNER_REPS)
FIT_STEPS = 10       # loss-decrease check: steps on one batch of CHECK_BATCH
CHECK_BATCH = 8      # shuffled-order kernel check and checked e2e batch
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
PARITY_SEEDS = (7, 8)    # contract parity (tests/test_tpu_parity.py)
PARITY_BATCH = 4
TIE_RATE = 5e-5      # tri_id mismatches allowed per covered pixel
CONTRACT_BARY = 5e-5     # contract vs oracle where tri_id agrees: bary,
CONTRACT_ZREL = 1e-4     # and zbuf relative (224 px readings 8.8e-6, 1.5e-5)
CONTRACT_ZEXACT = 2e-6   # contract zbuf vs the exact float64 depth,
                         # relative (224 px reading 4.5e-7)
FLOOR_BATCH = 128    # K5: benchmarks/floor_probe.py's defaults
FLOOR_TILE_H = 2
FLOOR_COLS = 4
FLOOR_CHECK = 32     # K5 images held against the plain versions
FLOOR_SKELETON = "sel,eval,dma,pack"   # floor_probe.py:6's skeleton
FLOOR_SENTINEL = -12345   # fills the outputs of the ablated launches
WIDE_TILE_H = 8      # wide band: tile_h 8 x one 224-px column
WIDE_BATCH = 4
SWEEP_TILE_H = (1, 2, 3, 4, 5, 8, 64, 136)   # band heights of the sweep
SWEEP_BATCH = 2
RASTER_COUNT_IMAGES = 8  # raster_bench's tests issued: its face order
                         # walks every chunk past the masks, 16 pixel
                         # groups a tile, so count the first 8 images
WALK_PROGS = 2048    # K6: benchmarks/ctzloop_probe.py's shape
WALK_REPORTED = 8    # live bits of the K6 line in the kernels JSON
FIT_BATCH = 8        # fit driver: synthetic targets
FIT_DRIVER_STEPS = 50    # fit driver: Adam steps (lr 5e-3)
INFER_FACES = 4      # infer driver: synthetic faces
FUSED_BF16 = 5e-2    # fused vs BN-eval coefficients, both bf16 (x max|c|)
TRAIN_DIR_FACES = 64     # train driver: PNG faces in the folder
TRAIN_DIR_BATCH = 32     # train driver: batch
TRAIN_DIR_STEPS = 12     # train driver: steps timed on each wire
TRACK_FRAMES = 16        # track, joint and --video: frames
TRACK_STEPS = 100        # track, joint and --video: refine steps
SEQ_FRAMES = 8           # track --sequential: frames
SEQ_STEPS = 25           # track --sequential: refine steps a frame
VIDEO_MAE = 0.03         # MJPG decode vs source, mean |err|
                         # (tests/test_real_input_drivers.py:115)
R512_BATCH = 256         # config 5: 512-px render, bench.py's render512
R512_MICRO = 32
# the binning's shapes: (where, px, tile_h, columns, batch)
BIN_RUNS = (("headline", 224, 4, 7, MICRO),
            ("render512", 512, 2, 8, R512_MICRO))
DP_BATCH = 32            # world-size-1 NCCL train step
RENDER_REPS = 1          # render_bench: reps and inner lowered from the
RENDER_INNER = 2         # reference's 3 and 8 to keep the script short
RENDER_RUNS = ((224, False), (224, True), (512, True))   # (--size, --bwd)
RENDER_HOLD_IMAGES = 8   # K1 and K4 held at 512 px on the first 8 images
PROBE_STEM_BF16 = 2.0 ** -6   # the stems in bf16: each output rounded twice
PROBE_STEM_F32 = 1e-5         # (accumulator, then after the bias), x max
PROBE_GATHER = 1e-6           # gather forms, card against CPU, x max |ref|
TEX_CELL = "deca-render224.b512"   # DECA's textured kernel: the cell,
TEX_BATCH = 256          # its microbatch,
TEX_CALLS = 2            # the counted calls (the cell's unit)
TEX_SEED = 22            # and the seed of the codes
GEO_RUNS = (("headline", 224, MICRO), ("render512", 512, 32))
GEO_ATOL = 1e-6          # geometry kernel vs its plain version on the card
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


def _launches(**counts) -> dict:
    """A path's launch counts: the named kernels' counts, 0 for the rest,
    and one launch of each binning kernel for each K1, K2, K4 and textured
    launch (each rasterizes windows that ops/rasterize.band_windows binned
    for it)."""
    from facerecon_tpu_torch.ops import _build
    want = dict.fromkeys(_build.KERNELS, 0) | counts
    n = (want["raster_shade"] + want["raster_select"] + want["raster_pos"]
         + want["raster_texture"])
    return want | {"bin_setup": n, "bin_windows": n}


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


def _group_tests(win, tile_h: int, n_cols: int, width: int):
    """(tests, f32 ops, tests issued) by the earlier group-based count,
    printed beside the count of _needed_tests so that rows compare.
    The tests: for each pixel group of each column tile
    (ops/rasterize.pixel_group), the triangles of the chunks its walk
    visits (the column's masked chunks of the first 64, then every chunk
    beyond) that the group's cull keeps (ops/rasterize.cull_keeps, the
    kernels' cull in float32, on the group's whole rectangle), times the
    group's pixels inside the tile. The ops: for each kept triangle,
    TEST_ADDS a pixel and AXIS_OPS for each of the group's pixel columns
    and rows inside the tile. The tests issued by the earlier design:
    every lane of the group's warp tested its micro-tile, 128 pixels a
    kept triangle."""
    from facerecon_tpu_torch.ops import rasterize as R
    col_w = R.col_width(width, n_cols)
    gw, gh = R.pixel_group(tile_h, col_w)
    setup = win.setup
    bsz, _, rows = setup.shape
    n_bands = win.blo.shape[1]
    dev = setup.device
    lane = torch.arange(32, device=dev, dtype=torch.int64)
    words = win.cmask.view(bsz, n_bands, n_cols, 2).to(torch.int64)
    bits = ((words[..., None] >> lane) & 1).reshape(
        bsz, n_bands, n_cols, 64).bool()
    j = torch.arange(128, device=dev)
    t_px = torch.arange(n_bands, device=dev) * tile_h
    c_px = torch.arange(n_cols, device=dev) * col_w
    tests = ops = issued = 0
    for b0 in range(0, bsz, 4):
        sl = slice(b0, b0 + 4)
        lo, n = win.blo[sl].long(), win.bn[sl].long()
        s = setup[sl]

        def gather(r):     # fields 0..10 at rows r (S, ...) -> (11, S, ...)
            flat = r.clamp(max=rows - 1).reshape(r.shape[0], -1)
            return torch.stack([s[:, k].gather(1, flat).view(r.shape)
                                for k in range(11)])
        # the masked chunks k < 64, then each chunk k >= 64 of the band
        fm = gather((lo[:, :, None, None] + torch.arange(64, device=dev)
                     [:, None]) * 128 + j)                # (11,S,T,64,128)
        beyond = [(gather((lo[:, :, None] + k) * 128 + j), n > k)
                  for k in range(64, int(n.max()))]
        for gy in range(0, tile_h, gh):
            for gx in range(0, col_w, gw):
                x0 = (c_px + gx).float() + 0.5             # (C,)
                y0 = (t_px + gy).float() + 0.5             # (T,)
                x1 = (c_px + gx + gw - 1).float() + 0.5
                y1 = (t_px + gy + gh - 1).float() + 0.5
                pc, pr = min(gw, col_w - gx), min(gh, tile_h - gy)
                kept = 0
                live = R.cull_keeps(
                    fm[:, :, :, None], x0[:, None, None],
                    x1[:, None, None], y0[:, None, None, None],
                    y1[:, None, None, None])            # (S,T,C,64,128)
                kept += int((live & bits[sl][..., None]).sum())
                for f, valid in beyond:
                    live = R.cull_keeps(f[:, :, :, None], x0[:, None],
                                      x1[:, None], y0[:, None, None],
                                      y1[:, None, None])    # (S,T,C,128)
                    kept += int((live & valid[:, :, None, None]).sum())
                tests += kept * pc * pr
                ops += kept * (TEST_ADDS * pc * pr + AXIS_OPS * (pc + pr))
                issued += kept * 32 * R._MICRO * R._MICRO
    return tests, ops, issued


def _tests_made(win, tile_h: int, n_cols: int, width: int,
                issued_images: int = None) -> dict:
    """The tests of K1, K2 and K4 on these windows (square images):
    `needed`/`needed_ops` what the inputs need (_needed_tests, the ops
    bound's count), `issued` what the kernels issue
    (ops/rasterize.tests_issued: `mask` the coverage tests of the
    micro-tile masks, `list` the z-tests of the lanes' lists; on the
    first issued_images images where given, `issued_images` then), and
    the earlier group-based count (_group_tests: `group`,
    `group_ops`, `group_issued`)."""
    from facerecon_tpu_torch.ops import rasterize as R
    needed, needed_ops = _needed_tests(win, width, width)
    mask, lists = R.tests_issued(
        win if issued_images is None else _head(win, issued_images),
        height=width, width=width, tile_h=tile_h, n_cols=n_cols)
    group, group_ops, group_issued = _group_tests(win, tile_h, n_cols,
                                                  width)
    return dict(needed=needed, needed_ops=needed_ops, issued=mask + lists,
                mask=mask, list=lists, group=group, group_ops=group_ops,
                group_issued=group_issued, issued_images=issued_images)


def _tests_line(what: str, t: dict) -> str:
    first = t["issued_images"]
    on = f" on the first {first} images" if first else ""
    return (f"{what} tests needed {t['needed']} ({t['needed_ops']} f32 "
            f"ops), issued{on} {t['issued']} (mask {t['mask']} + lists "
            f"{t['list']}); the earlier group-based count: made "
            f"{t['group']} ({t['group_ops']} f32 ops), issued by the old "
            f"design {t['group_issued']}")


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


def _bound(n_bytes: int, n_ops: int, name: str, old_ops: int = None):
    """(bound_ms, bound_by) for moving n_bytes and doing n_ops f32 ops.
    old_ops, where given (the rasterizers' earlier group-based count),
    is printed beside with the bound it gave."""
    t_bytes = n_bytes / H100_BYTES_S * 1e3
    t_ops = n_ops / H100_F32_S * 1e3
    old = ""
    if old_ops is not None:
        t_old = old_ops / H100_F32_S * 1e3
        old = (f" (the earlier group-based count: {old_ops} f32 ops -> "
               f"{t_old:.4f} ms, bound {max(t_bytes, t_old):.4f} ms)")
    print(f"{name} bound inputs: {n_bytes} bytes -> {t_bytes:.4f} ms; "
          f"{n_ops} f32 ops -> {t_ops:.4f} ms{old}")
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


def _check_raster(name, main_batch, cfg, assets, rng):
    """A rasterizer kernel against its plain version on both row orders.
    Returns the kernel line's numbers at the main path's shapes and the
    (windows, records, outputs) of each order's batch."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
    kernel, plain, _, rec_fields = _raster_kernels()[name]
    bfm = device_bfm(assets, DEVICE)
    s = cfg.image_size
    kw = dict(height=s, width=s, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              n_faces=assets.n_faces)
    result, max_err, main = {}, 0.0, {}
    for order, batch in (("raster_rows", main_batch),
                         ("shuffled", CHECK_BATCH)):
        rec, win = _inputs(cfg, bfm, sample_coeffs(rng, cfg, batch), order)
        got = kernel(win, rec, **kw)
        torch.cuda.synchronize()
        ref = plain(win, rec, **kw)
        torch.cuda.synchronize()
        err = _hold(name, got, ref, order)
        max_err = max(max_err, err)
        bn_max = int(win.bn.max())
        if order == "shuffled" and bn_max <= 64:
            raise AssertionError("shuffled order did not overflow the mask")
        pairs = _live_pairs(win, cfg)
        cover = float((got[0] >= 0).float().mean())
        ms = _time_ms(lambda: kernel(win, rec, **kw), reps=20)
        plain_ms = _time_ms(lambda: plain(win, rec, **kw), reps=1, warmup=0)
        print(f"{name}[{order}] batch={batch} max bn={bn_max} "
              f"coverage={cover:.4f} live pairs={pairs} "
              f"kernel={ms:.4f} ms plain={plain_ms:.2f} ms "
              f"max|err|={err:.3g} (tri_id exact)")
        if order == "raster_rows":
            t = _tests_made(win, cfg.tile_h, cfg.raster_cols, s)
            print(_tests_line(f"{name}[{order}]", t) + f"; the mask walk's "
                  f"pairs {pairs}")
            bound_ms, bound_by = _bound(
                _raster_bytes(win, got, rec_fields, cfg.raster_cols,
                              assets.n_faces), t["needed_ops"], name,
                t["group_ops"])
            result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        main[order] = (win, rec, got)
        del ref
    del bfm
    torch.cuda.empty_cache()
    return dict(result, max_abs_err=max_err), main


def _select_grad_times(row, g, blo, bn, rows, tile_h, where) -> dict:
    """K3's time on these inputs, the plain version's, one index_add_ of
    the same sums (the plain version's core), a zero fill of its output
    (the least K3 can take) and the bound. Prints them; returns the
    kernel line's numbers."""
    from facerecon_tpu_torch.ops import rasterize as R
    bsz = row.shape[0]
    kw = dict(rows=rows, tile_h=tile_h)
    ms = _time_ms(lambda: R.select_grad(row, g, blo, bn, **kw), reps=20)
    plain_ms = _time_ms(lambda: R.select_grad_reference(
        row, g, blo, bn, **kw), reps=1, warmup=0)
    hit = row >= 0
    src = g[:, :R._GRAD].permute(0, 2, 3, 1)[hit].contiguous()
    dst = (row.to(torch.int64) + torch.arange(
        bsz, device=DEVICE)[:, None, None] * rows)[hit]
    acc = torch.zeros((bsz * rows, R._GRAD), device=DEVICE)
    library_ms = _time_ms(lambda: acc.index_add_(0, dst, src), reps=20)
    out = torch.empty((bsz, R._FIELDS, rows), device=DEVICE)
    fill_ms = _time_ms(out.zero_, reps=20)
    # the cotangent is needed only at covered pixels: a background pixel
    # has no winner row and its g is never read
    n_hit = int(hit.sum())
    bound_ms, bound_by = _bound(
        _nbytes(row, blo, bn, out) + n_hit * R._GRAD * 4,
        n_hit * R._GRAD, f"select_grad ({where})")
    print(f"select_grad [{where}] batch={bsz} rows={rows} covered "
          f"px={n_hit} kernel={ms:.4f} ms plain={plain_ms:.2f} ms "
          f"index_add_={library_ms:.4f} ms output zero fill={fill_ms:.4f} "
          f"ms bound={bound_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _select_grad_once(row, blo, bn, rows, tile_h, where, seed):
    """K3 against its plain version on these winner rows with a cotangent
    drawn from a seed: max |diff| <= 1e-5 x max |ref|, two launches
    bitwise equal, fields 17..23 zero; then its times and bound
    (_select_grad_times). Returns the kernel line's numbers."""
    from facerecon_tpu_torch.ops import rasterize as R
    bsz, height, width = row.shape
    g = torch.randn((bsz, R._SEL, height, width), device=DEVICE,
                    generator=torch.Generator(DEVICE).manual_seed(seed))
    kw = dict(rows=rows, tile_h=tile_h)
    got = R.select_grad(row, g, blo, bn, **kw)
    again = R.select_grad(row, g, blo, bn, **kw)
    torch.cuda.synchronize()
    ref = R.select_grad_reference(row, g, blo, bn, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"select_grad is not deterministic: two "
                             f"launches differ ({where})")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not (scale > 0 and err <= 1e-5 * scale and not got[:, 17:].any()):
        raise AssertionError(f"select_grad differs from the plain version "
                             f"by {err} (max |ref| {scale}; {where})")
    print(f"select_grad [{where}] max|err|={err:.3g} (max|ref| "
          f"{scale:.3g}; two launches bitwise equal)")
    return dict(_select_grad_times(row, g, blo, bn, rows, tile_h, where),
                max_abs_err=err)


def check_select_grad(cfg, assets, main):
    """K3 at batch 128 on K2's asset-order winner rows (the kernel line's
    numbers), then on K2's shuffled-order winner rows at batch 8 plus one
    image 1 from the camera (translation z = 9), whose winner rows span
    several bands and some hold more than 128 pixels (the sum pass's
    long rows)."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import device_bfm
    win, rec, (_, row, _) = main["raster_rows"]
    rows = rec.shape[2]
    result = _select_grad_once(row, win.blo, win.bn, rows, cfg.tile_h,
                               "asset order", 5)
    del win, rec, row
    win, rec, (_, row, _) = main["shuffled"]
    bfm = device_bfm(assets, DEVICE)
    coeff = sample_coeffs(np.random.default_rng(9), cfg, 1)
    coeff[:, -1] = 9.0
    nrec, nwin = _inputs(cfg, bfm, coeff, "shuffled")
    s = cfg.image_size
    _, nrow, _ = R.select_windows(nwin, nrec, height=s, width=s,
                                  tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
                                  n_faces=assets.n_faces)
    r = nrow[0][nrow[0] >= 0].to(torch.int64)
    top = int(torch.bincount(r).argmax())
    ys = torch.nonzero(nrow[0] == top)[:, 0]
    longest = int((nrow[0] == top).sum())
    bands = int(ys.max()) // cfg.tile_h - int(ys.min()) // cfg.tile_h + 1
    print(f"select_grad near-camera image: its longest winner row has "
          f"{longest} px over {bands} bands")
    if not (longest > 128 and bands > 1):
        raise AssertionError("the near-camera image has no winner row of "
                             "more than 128 px over several bands")
    both = torch.cat([row, nrow])
    blo, bn = torch.cat([win.blo, nwin.blo]), torch.cat([win.bn, nwin.bn])
    _select_grad_once(both, blo, bn, rows, cfg.tile_h,
                      "shuffled order + near camera", 6)
    del bfm
    torch.cuda.empty_cache()
    return result


def check_wide_band(cfg, assets):
    """K1, K2 and K4 on a wide band, 1,792 pixels a column tile:
    tile_h 8 with one 224-px column (benchmarks/raster_bench.py's
    default), in the asset's raster row order (check_raster_bench runs
    its own face order), batch WIDE_BATCH. Each launches as it does at
    any size (one block of 128 threads a column tile of a band), is held
    against its plain version (tri_id exact; K1 color/bary within 1e-6,
    K2 and K4 exact) and is timed there."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
    wcfg = dataclasses.replace(cfg, tile_h=WIDE_TILE_H, raster_cols=1)
    bfm = device_bfm(assets, DEVICE)
    rec, win = _inputs(wcfg, bfm, sample_coeffs(
        np.random.default_rng(4), wcfg, WIDE_BATCH), "raster_rows")
    s = cfg.image_size
    kw = dict(height=s, width=s, tile_h=WIDE_TILE_H, n_cols=1,
              n_faces=assets.n_faces)
    for name, (kernel, plain, _, _) in _raster_kernels().items():
        got = kernel(win, rec, **kw)
        torch.cuda.synchronize()
        err = _hold(name, got, plain(win, rec, **kw),
                    f"wide band, tile_h {WIDE_TILE_H} x one {s}-px column")
        ms = _time_ms(lambda: kernel(win, rec, **kw), reps=20)
        print(f"wide band {name}: batch {WIDE_BATCH} tile_h {WIDE_TILE_H} x "
              f"one {s}-px column equal to the plain version (max|err| "
              f"{err:.3g}), {ms:.4f} ms")
    print(_tests_line("wide band:", _tests_made(win, WIDE_TILE_H, 1, s))
          + f"; mask walk {_live_pairs(win, wcfg)}")
    del bfm, rec, win
    torch.cuda.empty_cache()


def check_band_sweep(cfg, assets):
    """K1, K2 and K4 at full width on every band height the z-test must
    take (SWEEP_TILE_H: a 1-row band, whose micro-tiles' second rows lie
    past the tile, up to 136 rows, past the image; the config's columns
    at 1 and 4 rows, the floor's at 2, one column from 8; the odd
    heights 3 x 32-px and 5 x 16-px columns, whose pixel groups of 2 and
    3 micro-rows end in a micro-row with one pixel row in the tile), in
    the asset's row order at batch SWEEP_BATCH; then on
    a shuffled face order (tile_h 2 and 8), on saturated masks (every
    chunk bit set, tile_h 2) and with cull_backfaces on an image turned
    2.5 rad (tile_h 4), each at batch 1 or 2. Each held against its plain
    version (tri_id exact; K1 color/bary within 1e-6, K2 and K4 exact)."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import device_bfm
    bfm = device_bfm(assets, DEVICE)
    s = cfg.image_size
    kernels = _raster_kernels()

    def hold(rec, win, tile_h, n_cols, where):
        kw = dict(height=s, width=s, tile_h=tile_h, n_cols=n_cols,
                  n_faces=assets.n_faces)
        for name, (kernel, plain, _, _) in kernels.items():
            got = kernel(win, rec, **kw)
            torch.cuda.synchronize()
            _hold(name, got, plain(win, rec, **kw), where)
        print(f"band sweep: K1, K2, K4 equal to their plain versions "
              f"({where})")
    cols = {1: cfg.raster_cols, 2: FLOOR_COLS, 3: 7, 4: cfg.raster_cols,
            5: 14}
    cases = [(t, cols.get(t, 1), "raster_rows", SWEEP_BATCH, "")
             for t in SWEEP_TILE_H]
    cases += [(2, FLOOR_COLS, "shuffled", 1, ""), (8, 1, "shuffled", 1, ""),
              (2, FLOOR_COLS, "raster_rows", 2, "saturated"),
              (4, cfg.raster_cols, "raster_rows", 2, "cull")]
    for tile_h, n_cols, order, batch, how in cases:
        bcfg = dataclasses.replace(cfg, tile_h=tile_h, raster_cols=n_cols)
        coeff = sample_coeffs(np.random.default_rng(9), bcfg, batch)
        if how == "cull":
            coeff[-1, bcfg.coeff_split[2] + 1] = 2.5   # turned: back faces
        rec, win = _inputs(bcfg, bfm, coeff, order)
        if how == "saturated":
            win = win._replace(cmask=torch.full_like(win.cmask, -1))
        if how == "cull":
            from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry
            from facerecon_tpu_torch.utils.coeffs import split_coeff
            geom = coeffs_to_geometry(split_coeff(torch.as_tensor(
                coeff, device=DEVICE), bcfg), bfm, bcfg)
            win = R.band_windows(geom.verts_ndc, bfm.raster_rows,
                                 bfm.raster_row_id, s, s, tile_h, n_cols,
                                 cull_backfaces=True)
        hold(rec, win, tile_h, n_cols, f"{order}, tile_h {tile_h} x "
             f"{n_cols} columns, batch {batch}{', ' + how if how else ''}")
        del rec, win
    del bfm
    torch.cuda.empty_cache()


def _depth_f64(vndc, faces, ids, px, py, size: int):
    """The exact planar depth of face ids[k] at pixel center (px[k],
    py[k]), in float64 from the float32 vertices: the oracle's screen
    corners, edge functions and blend of the corner depths, unrounded."""
    v = vndc.astype(np.float64)
    x = (v[:, 0] + 1.0) * (size / 2.0)
    y = (1.0 - v[:, 1]) * (size / 2.0)
    f = faces[ids]
    (x0, x1, x2), (y0, y1, y2), (z0, z1, z2) = (
        [a[f[:, k]] for k in range(3)] for a in (x, y, v[:, 2]))
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    e0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    e1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    e2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    return (e0 * z0 + e1 * z1 + e2 * z2) / area


def check_contract(cfg, assets):
    """The §9.5 contract path on the card against the native oracle, with
    tests/test_tpu_parity.py's bar: over seeds 7 and 8 (batch 4,
    sample_coeffs scale 0.3) and both row orders, tri_id mismatches
    <= 5e-5 of covered pixels, and every mismatch a depth tie on a pixel
    both cover (|dz| < 1e-3); where tri_id agrees, bary within
    CONTRACT_BARY and zbuf within CONTRACT_ZREL relative, and within
    CONTRACT_ZEXACT relative of the exact float64 depth (the zbuf gap is
    split there into the kernel's and the oracle's). First K4 is held
    against its plain version on each order's windows (its two launch
    shapes here: the asset order's column tiles and the identity order's
    one 224-px column), and each contract call must return those checked
    tri_id and zbuf. One K4 launch a call; the launch counters are reset just
    before the calls and read just after. Returns the launch counts."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry, device_bfm
    from facerecon_tpu_torch.utils import native_oracle
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    native_oracle.require()
    bfm = device_bfm(assets, DEVICE)
    s = cfg.image_size
    n_faces = assets.n_faces
    orders = {"raster_rows": dict(n_cols=cfg.raster_cols,
                                  row_faces=bfm.raster_rows,
                                  row_id=bfm.raster_row_id),
              "identity": dict(n_cols=1)}
    verts = {}
    for seed in PARITY_SEEDS:
        c = split_coeff(torch.as_tensor(sample_coeffs(
            np.random.default_rng(seed), cfg, PARITY_BATCH, scale=0.3),
            device=DEVICE), cfg)
        verts[seed] = coeffs_to_geometry(c, bfm, cfg).verts_ndc

    # K4 against its plain version at the contract's launch shapes
    pos = {}
    for seed in PARITY_SEEDS:
        for order, okw in orders.items():
            win = R.band_windows(
                verts[seed], okw.get("row_faces", bfm.faces),
                okw.get("row_id", torch.arange(n_faces, device=DEVICE)),
                s, s, cfg.tile_h, okw["n_cols"])
            kw = dict(height=s, width=s, tile_h=cfg.tile_h,
                      n_cols=okw["n_cols"], n_faces=n_faces)
            got = R.pos_windows(win, **kw)
            torch.cuda.synchronize()
            _hold("raster_pos", got, R.pos_windows_reference(win, **kw),
                  f"contract, {order}, seed {seed}")
            pos[seed, order] = win.setup, got
    for order, okw in orders.items():
        col_w = R.col_width(s, okw["n_cols"])
        print(f"contract [{order}]: raster_pos equal to the plain version "
              f"(tri_id, zbuf, row) at {okw['n_cols']} column(s) of "
              f"{col_w} px, {cfg.tile_h * col_w} px a column tile, seeds "
              f"{PARITY_SEEDS}")
    torch.cuda.synchronize()

    # the contract path: counts from 0, one call per seed and order
    _build.reset_launches()
    outs = {}
    for seed in PARITY_SEEDS:
        for order, okw in orders.items():
            before = _build.LAUNCHES["raster_pos"]
            out = R.rasterize_batch(verts[seed], bfm.faces, height=s,
                                    width=s, cfg=cfg, **okw)
            if _build.LAUNCHES["raster_pos"] != before + 1:
                raise AssertionError("rasterize_batch did not launch "
                                     "raster_pos exactly once")
            _, (tid, zbuf, _) = pos[seed, order]
            if not (torch.equal(out[0], tid) and torch.equal(out[2], zbuf)):
                raise AssertionError("rasterize_batch's tri_id or zbuf is "
                                     "not the checked K4 output")
            outs[seed, order] = [t.cpu().numpy() for t in out]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"contract path: {len(outs)} rasterize_batch calls, launches "
          f"{launches}")
    if launches != _launches(raster_pos=len(outs)):
        raise AssertionError("the contract path did not launch raster_pos "
                             "once per call (and nothing else)")
    ms = _time_ms(lambda: R.rasterize_batch(
        verts[PARITY_SEEDS[0]], bfm.faces, height=s, width=s, cfg=cfg,
        **orders["raster_rows"]), reps=10)

    faces = assets.faces
    jj, ii = np.meshgrid(np.arange(s) + 0.5, np.arange(s) + 0.5)
    for order in orders:
        mism = cov = bad_depth = 0
        bary_err = z_rel = 0.0
        split = dict(kernel=0.0, oracle=0.0, evaluation=0.0, setup=0.0)
        for seed in PARITY_SEEDS:
            vndc = verts[seed].cpu().numpy()
            tid_t, bary_t, z_t = outs[seed, order]
            setup, (_, _, row) = pos[seed, order]
            for b in range(PARITY_BATCH):
                tid_o, bary_o, z_o = native_oracle.rasterize(vndc[b], faces,
                                                             s, s)
                covered = (tid_o >= 0) | (tid_t[b] >= 0)
                cov += int(covered.sum())
                d = covered & (tid_t[b] != tid_o)
                mism += int(d.sum())
                both = (tid_o >= 0) & (tid_t[b] >= 0)
                tie_ok = both & (np.abs(np.where(both, z_o, 0.0)
                                        - np.where(both, z_t[b], 0.0))
                                 < 1e-3)
                bad_depth += int((d & ~tie_ok).sum())
                same = both & ~d
                bary_err = max(bary_err, float(np.abs(
                    bary_t[b][same] - bary_o[same]).max()))
                zt, zo = z_t[b][same], z_o[same]
                z_rel = max(z_rel, float((np.abs(zt - zo) / zo).max()))
                # the gap against the exact depth: the kernel's float32
                # evaluation of its anchored form, that form's float32
                # coefficients (the setup), and the oracle's blend
                px, py = jj[same], ii[same]
                exact = _depth_f64(vndc[b], faces, tid_o[same], px, py, s)
                sf = setup[b].cpu().numpy()[:, row[b].cpu().numpy()[same]]
                za, zb, z0, x0, y0 = sf[6:11].astype(np.float64)
                affine = za * (px - x0) + zb * (py - y0) + z0
                for key, val in (("kernel", zt - exact),
                                 ("oracle", zo - exact),
                                 ("evaluation", zt - affine),
                                 ("setup", affine - exact)):
                    split[key] = max(split[key],
                                     float((np.abs(val) / exact).max()))
        rate = mism / cov
        print(f"contract parity [{order}] seeds {PARITY_SEEDS} batch "
              f"{PARITY_BATCH}: mismatch {mism} of {cov} covered px "
              f"(rate {rate:.3g}), bad_depth {bad_depth}; where tri_id "
              f"agrees max|bary diff| {bary_err:.3g} (bound "
              f"{CONTRACT_BARY:g}), max relative zbuf diff {z_rel:.3g} "
              f"(bound {CONTRACT_ZREL:g})")
        print(f"contract zbuf [{order}] max relative error against the "
              f"exact float64 depth: kernel {split['kernel']:.3g} (bound "
              f"{CONTRACT_ZEXACT:g}; its "
              f"float32 evaluation {split['evaluation']:.3g}, its float32 "
              f"setup {split['setup']:.3g}), oracle {split['oracle']:.3g}")
        if not (cov > 0 and rate <= TIE_RATE and bad_depth == 0):
            raise AssertionError(f"contract parity failed ({order})")
        if not (bary_err <= CONTRACT_BARY and z_rel <= CONTRACT_ZREL
                and split["kernel"] <= CONTRACT_ZEXACT):
            raise AssertionError(f"contract bary or zbuf beyond its bound "
                                 f"({order})")
    print(f"contract path: rasterize_batch batch {PARITY_BATCH} asset "
          f"order {ms:.4f} ms per call")
    del bfm, pos
    torch.cuda.empty_cache()
    return launches


def check_evaluate():
    """evaluate.run at full scale on the card: vertex MAE < 1e-3 and the
    contract met."""
    from facerecon_tpu_torch import evaluate
    report = evaluate.run(4, device=DEVICE)
    if not (report["vertex_mae"] < 1e-3 and report["meets_contract"]):
        raise AssertionError(f"evaluate failed the contract: {report}")
    torch.cuda.empty_cache()


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


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _hold_ablated(name, setting, outs, full) -> str:
    """The checks an ablated build's outputs can take, where its function
    is known: `cull` alone is the full kernel bit for bit, `eval` alone
    gives background, `pack` alone leaves the sentinel untouched. Raises
    on a failure; returns what was checked."""
    background = {"raster_shade": (-1, 0.0, 0.0),
                  "raster_select": (-1, -1, 0.0),
                  "raster_pos": (-1, float("inf"), -1)}[name]
    if setting == "cull":
        if not all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(outs, full)):
            raise AssertionError(f"{name} with cull stripped differs from "
                                 f"the full kernel")
        return "equal to the full kernel bit for bit"
    if setting == "eval":
        if not all(bool((t == v).all()) for t, v in zip(outs, background)):
            raise AssertionError(f"{name} with eval stripped is not "
                                 f"background everywhere")
        return "background everywhere"
    if setting == "pack":
        if not all(bool((t == FLOOR_SENTINEL).all()) for t in outs):
            raise AssertionError(f"{name} with pack stripped wrote an "
                                 f"output")
        return "outputs untouched"
    return "values not checked"


def check_floor(cfg, assets):
    """K5: K1, K2 and K4 alone on inputs precomputed once, at
    benchmarks/floor_probe.py's defaults, with the real chunk masks and
    with every mask bit set (every chunk of the first 64 of a window is
    tested; values not checked, only the time). Each kernel's real-mask
    call is first held against its plain version on its first
    FLOOR_CHECK images. Then each ablated build (floor_probe's RP_ABLATE:
    each phase alone and the skeleton) is launched through the twin on
    the real masks, into outputs filled with a sentinel, held where its
    function is known (_hold_ablated), and timed beside the full kernel,
    with its SASS opcode mix. It prints the tests the inputs need, the
    tests the kernels issue and the earlier group-based count
    (_tests_made), and the full kernels' opcode mixes beside the
    ablated builds'."""
    from facerecon_tpu_torch.benchmarks import floor_probe as FP
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
    variants = _floor_builds()
    fcfg = dataclasses.replace(cfg, tile_h=FLOOR_TILE_H,
                               raster_cols=FLOOR_COLS)
    bfm = device_bfm(assets, DEVICE)
    rec, win = _inputs(fcfg, bfm, sample_coeffs(
        np.random.default_rng(0), fcfg, FLOOR_BATCH, scale=0.0),
        "raster_rows")
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
            f"floor {name} (real masks)", counts["group_ops"])
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
        # the ablated builds on the real masks (values checked only by
        # _hold_ablated: cull, eval and pack alone)
        mode = modes[name]
        fkw = dict(size=s, tile_h=fcfg.tile_h, n_cols=fcfg.raster_cols,
                   n_faces=assets.n_faces)
        for setting in _floor_settings(mode):
            defines, sass = variants[(mode, setting)]
            outs = FP.outputs(mode, FLOOR_BATCH, s, DEVICE,
                              fill=FLOOR_SENTINEL)
            FP.launch(mode, win, rec, outs, defines=defines, **fkw)
            torch.cuda.synchronize()
            held = _hold_ablated(name, setting, outs, got)
            t = _time_ms(lambda: FP.launch(mode, win, rec, outs,
                                           defines=defines, **fkw), reps=8)
            print(f"floor {name} RP_ABLATE={setting}: {t:.4f} ms against "
                  f"the full kernel's {t_real:.4f} ms ({t - t_real:+.4f} ms, "
                  f"{t / t_real:.3f} of it); {held}; SASS opcodes: {sass}")
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
    for each live-bit count, and so is its CTZ_UNROLLED build (the
    probe's looped=0 walk, through the twin
    benchmarks/ctzloop_probe.walk); then the timed probe run (the
    counters reset just before and read just after), and the unrolled
    walk timed after it. Returns the kernel line's numbers (at
    WALK_REPORTED live bits; the bound of the per-program walk the probe
    makes) and the launch counts of the __ffs walk's run."""
    from facerecon_tpu_torch.benchmarks import ctzloop_probe
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import probes
    setup, masks = ctzloop_probe.inputs(DEVICE, WALK_PROGS)
    for live, mask in masks.items():
        ref = probes.ctz_walk_reference(mask, setup)
        for looped in (True, False):
            got = ctzloop_probe.walk(mask, setup, looped)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise AssertionError(
                    f"ctz_walk (looped={int(looped)}) differs from the "
                    f"plain version at {bad} values ({live} live bits)")

    # the probe's run: counts from 0
    _build.reset_launches()
    times = {live: _time_ms(lambda: probes.ctz_walk(mask, setup), reps=20)
             for live, mask in masks.items()}
    launches = dict(_build.LAUNCHES)
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
              f" ms (equal to the plain version)")
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
                max_abs_err=0.0), launches


def _bin_kernel_ms(run, reps: int) -> dict:
    """Device ms a call of each binning kernel: reps calls of run() after
    a warm-up, in one torch.profiler pass, the kernels matched by their
    ops/_build.SYMBOLS."""
    from torch.profiler import ProfilerActivity, profile
    from facerecon_tpu_torch import profile_trace
    from facerecon_tpu_torch.ops import _build
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    top = profile_trace.summarize(profile_trace.trace_events(prof),
                                  n_top=100)["top"]
    return {k: sum(ms for name, _, ms, _ in top
                   if profile_trace._runs(name, _build.SYMBOLS[k])) / reps
            for k in ("bin_setup", "bin_windows")}


def check_binning(cfg, assets):
    """The binning kernels (csrc/binning.cu, through
    ops/rasterize.band_windows) against their plain version at each
    BIN_RUNS shape (the headline's microbatch, render512's), on the
    asset's raster row order and on a shuffled order: Windows bit for bit
    (_hold_windows), one launch of each kernel a call and nothing else.
    On the raster row order, timed: ms a call (CUDA events), each
    kernel's device ms (one profiler pass), the plain version's ms, and
    the bytes bound (the padded setup written, the vertices read).
    Returns the kernels line's numbers at the headline's shape."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry, device_bfm
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    bfm = device_bfm(assets, DEVICE)
    perm = torch.as_tensor(np.random.default_rng(3).permutation(
        bfm.faces.shape[0]), device=DEVICE)
    orders = {"raster_rows": (bfm.raster_rows, bfm.raster_row_id),
              "shuffled": (bfm.faces[perm], perm)}
    result = {}
    for where, size, tile_h, n_cols, batch in BIN_RUNS:
        scfg = dataclasses.replace(cfg, image_size=size,
                                   focal=cfg.focal * size / cfg.image_size,
                                   tile_h=tile_h, raster_cols=n_cols)
        c = split_coeff(torch.as_tensor(sample_coeffs(
            np.random.default_rng(4), scfg, batch), device=DEVICE), scfg)
        vndc = coeffs_to_geometry(c, bfm, scfg).verts_ndc
        for order, (rows, rid) in orders.items():
            args = (vndc, rows, rid, size, size, tile_h, n_cols)
            _build.reset_launches()
            got = R.band_windows(*args)
            torch.cuda.synchronize()
            if dict(_build.LAUNCHES) != _launches() | {"bin_setup": 1,
                                                        "bin_windows": 1}:
                raise AssertionError(f"binning ({where}, {order}) launched "
                                     f"{dict(_build.LAUNCHES)}")
            _hold_windows(got, R.band_windows_reference(*args),
                          f"{where}, {order}")
            bn_max = int(got.bn.max())
            print(f"binning[{order}] {where}: batch {batch}, {size} px, "
                  f"tile_h {tile_h} x {n_cols} columns, max bn {bn_max}: "
                  f"Windows bit for bit the plain version's")
            if order != "raster_rows":
                continue
            ms = _time_ms(lambda: R.band_windows(*args), 20)
            plain_ms = _time_ms(lambda: R.band_windows_reference(*args),
                                REPS)
            split = _bin_kernel_ms(lambda: R.band_windows(*args), 20)
            bound_ms, bound_by = _bound(_nbytes(got.setup, vndc), 0,
                                        f"binning ({where})")
            print(f"binning {where}: {ms:.4f} ms a call (bin_setup "
                  f"{split['bin_setup']:.4f}, bin_windows "
                  f"{split['bin_windows']:.4f} ms device), plain "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                  f"({100 * bound_ms / ms:.1f}% of it) on {_card_line()}")
            if where == "headline":
                result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, max_abs_err=0.0)
        del vndc, got
    del bfm, orders
    torch.cuda.empty_cache()
    return result


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


def check_geometry(cfg, assets):
    """The geometry kernel (csrc/geometry.cu, through
    ops/geometry.vertex_pass) at each GEO_RUNS shape on the basis products
    of sample_coeffs faces: one launch a call and nothing else; held
    against its plain version run on the card, the eager path's forward
    op for op (shape and texture bit for bit, every other field within
    GEO_ATOL, the landmarks within GEO_ATOL relative); timed with CUDA
    events (the kernel, the whole layer through coeffs_to_geometry under
    no_grad, the plain version), each device op's ms, and
    the bound: the bases read and the six (B, N, 3) planes and the
    landmarks written, and the basis products' FMAs (one f32 instruction
    each). Returns the kernels line's numbers at the headline's shape."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops import _build
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
        _build.reset_launches()
        got = G.vertex_pass(parts, c, bfm, scfg)
        torch.cuda.synchronize()
        if dict(_build.LAUNCHES) != _launches(geometry=1):
            raise AssertionError(f"geometry ({where}) launched "
                                 f"{dict(_build.LAUNCHES)}")
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


def check_texture():
    """DECA's textured kernel on the path of TEX_CELL (the docstring's
    phase 3). Returns the kernels line's numbers and the path's launch
    counts."""
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import flame as FL
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.render import render_coeffs
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    from facerecon_tpu_torch.utils.flame import flame_assets
    from perfbench import spec, work_flame
    from perfbench.kinds import flame_render as FR
    from perfbench.reference import deca
    cfgf = spec.cell(TEX_CELL)["config_file"]
    cfg = FR.port_config(cfgf, TEX_BATCH)
    arrays = FR.arrays(cfgf)
    dfl = FL.device_flame(flame_assets(arrays, cfg.image_size), DEVICE,
                          cfg.n_tex, cfg.uv_size)
    codes = torch.from_numpy(FR.sample_codes(np.random.default_rng(
        TEX_SEED), cfgf["sizes"], TEX_BATCH)).to(DEVICE)
    with _recording("texture_windows", "band_windows") as seen, \
            torch.no_grad():
        render_coeffs(split_coeff(codes, cfg), dfl, cfg, inference=True)
        torch.cuda.synchronize()
        _build.reset_launches()
        for _ in range(TEX_CALLS):
            render_coeffs(split_coeff(codes, cfg), dfl, cfg, inference=True)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    if launches != _launches(raster_texture=TEX_CALLS):
        raise AssertionError(f"the textured render launched {launches} in "
                             f"{TEX_CALLS} calls")
    args, kw = seen["texture_windows"]
    bargs, bkw = seen["band_windows"]
    _hold_windows(R.band_windows(*bargs, **bkw),
                  R.band_windows_reference(*bargs, **bkw), "textured path")
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
            codes, deca.flame_on(arrays, DEVICE), cfg.image_size,
            cfg.uv_size)
    bound_ms, bound_by = _bound(n_bytes, n_ops, "raster_texture")
    print(f"raster_texture[{TEX_CELL}] batch={TEX_BATCH} "
          f"{cfg.image_size} px tile_h {cfg.tile_h} x {cfg.raster_cols} "
          f"columns coverage={cover:.4f} kernel={ms:.4f} ms "
          f"plain={plain_ms:.2f} ms bound={bound_ms:.4f} ms ({bound_by}) "
          f"max|err|={err:.3g} (tri_id exact, binning bit for bit); "
          f"launches in {TEX_CALLS} calls {launches} on {_card_line()}")
    del seen, args, bargs, dfl, codes
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err), launches


def check_end_to_end(cfg, assets):
    """The inference main path: a checked small batch of the random-weight
    pipeline, a CPU float32 comparison, its stage split and its timed
    pass (the inference figure's earlier workload); then bench.headline,
    the reference's workload, counted, its first K1 call held and timed,
    and its stage split. Returns the headline's launch counts."""
    from facerecon_tpu_torch import bench
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import rasterize as R
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

    # stage split of one microbatch (the port's spans, after warm-up)
    batch = torch.rand((BATCH, s, s, 3),
                       generator=torch.Generator().manual_seed(2)).to(DEVICE)
    _span_split(f"random head, microbatch {MICRO}",
                lambda: pipe.reconstruct(batch[:MICRO]))

    # the workload the inference figure timed before the benchmark's
    # headline, once: these random weights (each image regresses a pose
    # and shape of its own) on random images, timed by the benchmark's
    # own timer and pass
    dt, _ = bench.timed(lambda: bench.headline_pass(pipe, batch, MICRO),
                        REPS, torch.device(DEVICE))
    print(f"random-head workload: {BATCH / dt:.1f} faces/s "
          f"(batch {BATCH} in microbatches of {MICRO}, {dt * 1e3:.1f} ms a "
          f"pass, {REPS} passes) on {_card_line()}")
    del pipe, batch
    torch.cuda.empty_cache()

    # the main path: bench.headline, the reference's workload (the BN
    # model's initial state, zero head, folded; images from
    # default_rng(0)), counts from 0 just before and read just after
    with _recording("shade_windows", "band_windows") as seen:
        _build.reset_launches()
        payload, (cv, means) = bench.headline(BATCH, MICRO, HEAD_REPS,
                                              HEAD_INNER_REPS, DEVICE)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    print(json.dumps(payload))
    n_calls = (1 + HEAD_REPS * HEAD_INNER_REPS) * (BATCH // MICRO)
    print(f"headline: {payload['value']:.1f} faces/s (batch {BATCH} in "
          f"microbatches of {MICRO}, bf16 fused ResNet-50 from the "
          f"reference's initial BN state, {s} px, {HEAD_REPS} x "
          f"{HEAD_INNER_REPS} timed passes after 1) on {_card_line()}")
    print(f"inference main path: {n_calls} reconstruct calls, launches "
          f"{launches}")
    if launches != _launches(raster_shade=n_calls, geometry=n_calls):
        raise AssertionError("the inference main path did not launch "
                             "raster_shade and the binning kernels once "
                             "per call (and nothing else)")
    if cv.any() or not bool(torch.isfinite(means).all()):
        raise AssertionError("headline: coefficients not all 0 (the "
                             "reference's zero head) or non-finite images")
    _hold_recorded(seen, f"headline (microbatch {MICRO})")
    (win, rec), kw = seen["shade_windows"]
    k1_ms = _time_ms(lambda: R.shade_windows(win, rec, **kw), REPS)
    t = _tests_made(win, cfg.tile_h, cfg.raster_cols, s)
    print(_tests_line("headline K1", t))
    bound_ms, bound_by = _bound(_raster_bytes(
        win, R.shade_windows(win, rec, **kw),
        _raster_kernels()["raster_shade"][3], cfg.raster_cols,
        assets.n_faces), t["needed_ops"], "raster_shade (headline)",
        t["group_ops"])
    print(f"headline K1: {k1_ms:.3f} ms a launch of {MICRO} (every image "
          f"the mean face), bound {bound_ms:.4f} ms by {bound_by}")
    del seen, cv, means, win, rec
    # the stage split of the headline's own model and images
    head = bench.headline_pipeline(cfg, assets, DEVICE)
    images = torch.from_numpy(bench.headline_images(MICRO, s)).to(DEVICE)
    _span_split(f"headline, microbatch {MICRO}",
                lambda: head.reconstruct(images))
    del head, images
    torch.cuda.empty_cache()
    return launches


def _span_split(what: str, run):
    """ms of each stage of one run() after a warm-up run, read from the
    port's own spans (profile_trace.span): one torch.profiler pass
    through profile_trace.summarize's stages, each the device time of
    the kernels, copies and fills it launched, on any thread, the
    backward cut at its fr.coeff_grad mark. Fails on a stage whose
    device events start before its host span."""
    from torch.profiler import ProfilerActivity, profile
    from facerecon_tpu_torch import profile_trace
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    s = profile_trace.summarize(profile_trace.trace_events(prof))
    st = s["stages"]
    early = {k: r["early"] for k, r in st.items() if r["early"]}
    if early:
        raise AssertionError(f"stage split ({what}): device events start "
                             f"before their span: {early}")
    ms = {k: r["device_ms"] for k, r in st.items() if k != "fr.coeff_grad"}
    if "fr.render" in ms:
        ms["fr.render rest"] = ms["fr.render"] - sum(
            ms.get(k, 0.0) for k in ("fr.geometry", "fr.records",
                                     "fr.binning"))
    print(f"stage ms ({what}, from the port's spans): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; busy {s['busy_ms']:.3f}")


def check_training(cfg, assets):
    """The training main path: a stage split and the loss-decrease check;
    then bench.train (1 warm-up and REPS timed iterations of TRAIN_CHUNK
    steps at batch TRAIN_BATCH) with the launch counters reset just
    before and read just after, its first K2 and K3 calls held. Returns
    the main path's launch counts."""
    from facerecon_tpu_torch import bench
    from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.pipeline import make_train_pipeline
    from facerecon_tpu_torch.train import init_state, make_train_step
    s = cfg.image_size
    pipe = make_train_pipeline(cfg, assets, device=DEVICE)
    state = init_state(pipe, total_steps=1000, seed=0)
    step = make_train_step(pipe)
    images, lmk = (torch.from_numpy(x[0]).to(DEVICE)
                   for x in bench.train_inputs(1, TRAIN_BATCH, s))
    _span_split(f"train step, batch {TRAIN_BATCH}",
                lambda: step(state, images, lmk))

    # the loss falls on one rendered batch (bench.py's 1000-step schedule)
    state = init_state(pipe, total_steps=1000, seed=0)
    gt = sample_coeffs(np.random.default_rng(3), cfg, CHECK_BATCH)
    images, lmk = render_batch(gt, pipe.bfm, cfg)
    losses = [float(step(state, images, lmk)["total"])
              for _ in range(FIT_STEPS)]
    print("loss-decrease check (batch %d, %d steps): %s"
          % (CHECK_BATCH, FIT_STEPS, " ".join(f"{x:.5f}" for x in losses)))
    if not losses[-1] < losses[0]:
        raise AssertionError("the training loss did not fall")
    del pipe, state, images, lmk
    torch.cuda.empty_cache()

    # the main path: bench.train, counts from 0 just before and read just
    # after. A non-finite gradient in any step but the last would reach
    # the weights through Adam and the last step's loss, which is checked.
    with _recording("select_windows", "select_grad") as seen:
        _build.reset_launches()
        payload, parts = bench.train(TRAIN_BATCH, REPS, TRAIN_CHUNK, DEVICE)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    print(json.dumps(payload))
    n_steps = (1 + REPS) * TRAIN_CHUNK
    print(f"train: {payload['value']:.1f} faces/s (batch {TRAIN_BATCH}, bf16 "
          f"BN ResNet-50, {s} px, fwd+bwd+Adam, {REPS} x {TRAIN_CHUNK} timed "
          f"steps after {TRAIN_CHUNK}) on {_card_line()}")
    print(f"training main path: {n_steps} steps, launches {launches}, last "
          f"loss {float(parts['total']):.5f}")
    if launches != _launches(raster_select=n_steps, select_grad=n_steps):
        raise AssertionError(f"the training main path launched {launches}")
    if not bool(torch.isfinite(torch.stack(list(parts.values()))).all()):
        raise AssertionError(f"non-finite training loss {parts}")
    _hold_recorded(seen, f"train (batch {TRAIN_BATCH})")
    del seen, parts
    torch.cuda.empty_cache()
    return launches


# the path's kernel wrappers in ops.rasterize -> the kernel each launches
_WRAPPERS = {"shade_windows": "raster_shade",
             "select_windows": "raster_select",
             "select_grad": "select_grad",
             "pos_windows": "raster_pos",
             "band_windows": "bin_setup"}


def _copy(x):
    """A detached copy of a wrapper argument (tensors, Windows tuples)."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple):
        items = map(_copy, x)
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@contextlib.contextmanager
def _recording(*names):
    """While open, each named wrapper of ops.rasterize keeps a copy of the
    arguments of its first call and passes every call on unchanged, so
    the path runs (and counts its launches) as it does without it.
    Yields wrapper name -> (args, kwargs), or None until it is called."""
    from facerecon_tpu_torch.ops import rasterize as R
    seen = dict.fromkeys(names)
    orig = {n: getattr(R, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kw):
            if seen[name] is None:
                seen[name] = (_copy(args), dict(kw))
            return fn(*args, **kw)
        return call
    for n in names:
        setattr(R, n, wrap(n, orig[n]))
    try:
        yield seen
    finally:
        for n in names:
            setattr(R, n, orig[n])


def _hold_recorded(seen, where) -> dict:
    """Each recorded first call's kernel against its plain version on the
    same arguments: K1 tri_id exact, color and bary within 1e-6; K2
    tri_id, row and sel exactly equal; K3 within 1e-5 x max |ref| and
    two launches bitwise equal; K4 tri_id, zbuf and row exactly equal;
    the binning's Windows bit for bit (_hold_windows). Fails if a wrapper
    the recording was opened for was never called.
    Returns kernel name -> max |err|; prints one line."""
    from facerecon_tpu_torch.ops import rasterize as R
    errs, parts = {}, []
    for wrapper, call in seen.items():
        if call is None:
            raise AssertionError(f"{where}: {wrapper} was never called")
        args, kw = call
        name = _WRAPPERS[wrapper]
        got = getattr(R, wrapper)(*args, **kw)
        ref = getattr(R, wrapper + "_reference")(*args, **kw)
        torch.cuda.synchronize()
        if name == "bin_setup":
            err = _hold_windows(got, ref, where)
        elif name == "select_grad":
            err, scale = float((got - ref).abs().max()), float(
                ref.abs().max())
            if not (scale > 0 and err <= 1e-5 * scale):
                raise AssertionError(f"select_grad differs from the plain "
                                     f"version by {err} (max |ref| "
                                     f"{scale}; {where})")
            if not torch.equal(got, getattr(R, wrapper)(*args, **kw)):
                raise AssertionError(f"select_grad is not deterministic: "
                                     f"two launches differ ({where})")
        else:
            err = _hold(name, got, ref, where)
        errs[name] = err
        # the records (B, 24, rows), K3's cotangent (B, 20, H, W), for
        # K4, which takes the windows alone, the setup (B, 16, rows), and
        # for the binning the vertices (B, N, 3)
        shape = (args[0].shape if name == "bin_setup" else args[1].shape
                 if len(args) > 1 else args[0].setup.shape)
        label = "binning" if name == "bin_setup" else name
        parts.append(f"{label} on {tuple(shape)} max|err| {err:.3g}")
        del got, ref
    print(f"{where}: the path's first call of each kernel held against "
          f"its plain version: " + ", ".join(parts))
    return errs


def _write_faces(root, images, lmk):
    """Images (N,S,S,3) on any device and landmarks -> PNG files with
    68-point side-cars."""
    from PIL import Image
    os.makedirs(root)
    for i, (img, lm) in enumerate(zip(images, lmk)):
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, f"face_{i:03d}.png"))
        np.savetxt(os.path.join(root, f"face_{i:03d}.txt"), lm, fmt="%.4f")


def check_fit(cfg, assets, tmp):
    """The fit driver at full width: make_fit_fn on FIT_BATCH synthetic
    targets, FIT_DRIVER_STEPS Adam steps at lr 5e-3 with landmarks, the
    counters reset just before the timed fit and read just after (one K2
    and one K3 launch a step, one more K2 for the final loss); the
    arguments of its first K2 and K3 calls are recorded and the kernels
    held against their plain versions on them; the loss falls and falls
    at 95% of steps. Then fit.run on a PNG folder of FIT_BATCH rendered
    faces, whose meshes must load back. Returns the launch counts."""
    from facerecon_tpu_torch import fit
    from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops.geometry import device_bfm
    from facerecon_tpu_torch.utils.obj_io import load_obj
    bfm = device_bfm(assets, DEVICE)
    gt = sample_coeffs(np.random.default_rng(4), cfg, FIT_BATCH)
    target, lmk = render_batch(gt, bfm, cfg)
    zero = torch.zeros((FIT_BATCH, cfg.n_coeff), device=DEVICE)
    fit.make_fit_fn(cfg, 2, lr=5e-3)(zero, bfm, target, lmk)   # warm-up
    torch.cuda.synchronize()
    fn = fit.make_fit_fn(cfg, FIT_DRIVER_STEPS, lr=5e-3)
    with _recording("select_windows", "select_grad") as seen:
        _build.reset_launches()
        t0 = time.perf_counter()
        res = fn(zero, bfm, target, lmk)
        losses = res.losses.cpu().numpy()
        dt = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    _hold_recorded(seen, f"fit step 1 (batch {FIT_BATCH})")
    del seen
    ms = dt * 1e3 / FIT_DRIVER_STEPS
    print(f"fit: {ms:.3f} ms/step, {FIT_BATCH * FIT_DRIVER_STEPS / dt:.1f} "
          f"faces x steps/s (batch {FIT_BATCH}, {cfg.image_size} px, "
          f"{FIT_DRIVER_STEPS} steps, final loss included) on {_card_line()}")
    print(f"fit losses: first {losses[0]:.5f} last {losses[-1]:.5f}; "
          f"launches {launches}")
    want = _launches(raster_select=FIT_DRIVER_STEPS + 1,
                     select_grad=FIT_DRIVER_STEPS, geometry=1)
    if launches != want:
        raise AssertionError(f"the fit launched {launches}, not {want}")
    short = fit.make_fit_fn(cfg, 5, lr=5e-3)
    busy = _busy_ms(lambda: short(zero, bfm, target, lmk))[0] / 6
    print(f"fit: device busy {busy:.3f} ms a step (torch.profiler, 5 steps "
          f"and the final loss) of {ms:.3f} ms ({100 * busy / ms:.1f}%)")
    monotone = float(np.mean(np.diff(losses) <= 1e-4))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and monotone > 0.9):
        raise AssertionError(f"the fit loss did not fall (monotone share "
                             f"{monotone}): {losses}")

    root, out = os.path.join(tmp, "fit_photos"), os.path.join(tmp, "fit_out")
    _write_faces(root, target.cpu().numpy(), lmk.cpu().numpy())
    rep = fit.run(fit.parse_args(["--images", root, "--landmarks", "--out",
                                  out, "--steps", str(FIT_DRIVER_STEPS),
                                  "--device", DEVICE]))
    if not (rep["batch"] == FIT_BATCH and rep["loss_last"] < rep["loss_first"]
            and np.isfinite(rep["landmark_rmse_px"])):
        raise AssertionError(f"fit.run on a photo folder: {rep}")
    for i in range(FIT_BATCH):
        v, c, f = load_obj(os.path.join(out, f"face_{i:03d}_fit.obj"))
        if not (v.shape == c.shape == (assets.n_vertices, 3)
                and np.array_equal(f, assets.faces)
                and np.isfinite(v).all()):
            raise AssertionError(f"face_{i:03d}_fit.obj does not load back")
    del bfm, target, res
    torch.cuda.empty_cache()
    return launches


def _crafted_checkpoint(cfg, assets, path):
    """A training checkpoint of the BatchNorm ResNet-50 whose fold is not
    trivial: every BN's scale, shift and running statistics perturbed
    (seeded) and a head whose coefficients have a std of ~0.1 on random
    images."""
    from facerecon_tpu_torch.checkpoint import CheckpointManager
    from facerecon_tpu_torch.models.resnet import BatchNorm
    from facerecon_tpu_torch.pipeline import make_train_pipeline
    pipe = make_train_pipeline(cfg, assets, device=DEVICE)
    gen = torch.Generator().manual_seed(11)

    def randn(n):
        return torch.randn(n, generator=gen).to(DEVICE)
    with torch.no_grad():
        for mod in pipe.model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.weight.numel()
                mod.weight.copy_(1.0 + 0.1 * randn(n))
                mod.bias.copy_(0.1 * randn(n))
                mod.running_mean.copy_(0.1 * randn(n))
                mod.running_var.copy_((1.0 + 0.1 * randn(n)).abs() + 0.01)
        head = pipe.model.head
        head.weight.copy_(torch.randn(head.weight.shape, generator=gen))
        images = torch.rand((4, cfg.image_size, cfg.image_size, 3),
                            generator=gen).to(DEVICE)
        pipe.model.eval()
        head.weight.mul_(0.1 / float(pipe.model(images).std()))
    CheckpointManager(path).save(0, {"model": pipe.model.state_dict(),
                                     "step": 0})
    del pipe
    torch.cuda.empty_cache()


def check_infer(cfg, assets, tmp):
    """The infer driver at full width on INFER_FACES synthetic faces, with
    --overlay --depth, from a crafted checkpoint: once on the BatchNorm
    model and once --fused. Every output file exists, the fused
    coefficients agree with the BN-eval ones within FUSED_BF16 x
    max|c|, the landmark RMSE is finite, and each run launched K2 (its
    one reconstruct) and K1 (the synthetic render), each held against its
    plain version on the arguments the run gave it. Returns the launch
    counts of the BN run."""
    from facerecon_tpu_torch import infer
    from facerecon_tpu_torch.ops import _build
    ck = os.path.join(tmp, "infer_ck")
    _crafted_checkpoint(cfg, assets, ck)
    coeffs, counts = {}, {}
    for mode in ("bn", "fused"):
        out = os.path.join(tmp, f"infer_{mode}")
        argv = ["--synthetic", str(INFER_FACES), "--out", out, "--ckpt", ck,
                "--overlay", "--depth", "--device", DEVICE] + (
                    ["--fused"] if mode == "fused" else [])
        with _recording("shade_windows", "select_windows") as seen:
            _build.reset_launches()
            rep = infer.run(infer.parse_args(argv))
            counts[mode] = dict(_build.LAUNCHES)
        if counts[mode] != _launches(raster_shade=1, raster_select=1,
                                     geometry=2):
            raise AssertionError(f"infer ({mode}) launched {counts[mode]}")
        _hold_recorded(seen, f"infer ({mode}, {INFER_FACES} faces)")
        del seen
        for i in range(INFER_FACES):
            for suffix in (".obj", "_render.png", "_landmarks.txt",
                           "_coeffs.npy", "_overlay.png", "_depth.png"):
                if not os.path.exists(os.path.join(
                        out, f"synthetic_{i}{suffix}")):
                    raise AssertionError(f"infer ({mode}) did not write "
                                         f"synthetic_{i}{suffix}")
        if not np.isfinite(rep["landmark_rmse_px"]):
            raise AssertionError(f"infer ({mode}): {rep}")
        coeffs[mode] = np.stack([np.load(os.path.join(
            out, f"synthetic_{i}_coeffs.npy")) for i in range(INFER_FACES)])
        print(f"infer ({mode}): {rep}")
    diff = float(np.abs(coeffs["fused"] - coeffs["bn"]).max())
    scale = float(np.abs(coeffs["bn"]).max())
    print(f"infer: fused vs BN-eval coefficients max diff {diff:.4g} "
          f"(max|c| {scale:.4g}, {diff / scale:.4g} of it; bar "
          f"{FUSED_BF16}); launches {counts}")
    if not (scale > 0 and diff <= FUSED_BF16 * scale):
        raise AssertionError("the fused model disagrees with the BN model")
    return counts["bn"]


def _photo_folder(cfg, assets, root, n):
    """n rendered faces, each warped by a random similarity (rotation
    +-0.3 rad, scale 0.85-1.15, shift +-10% of the size) inside the
    frame, as PNG with the warped 68-point side-cars: --align 68pt must
    undo the warp."""
    from facerecon_tpu_torch.data.preprocess import warp_affine
    from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
    bfm = device_bfm(assets, DEVICE)
    rng = np.random.default_rng(12)
    images, lmks = [], []
    for _ in range(0, n, 16):
        img, lm = render_batch(sample_coeffs(rng, cfg, 16), bfm, cfg)
        images.append(img.cpu().numpy())
        lmks.append(lm.cpu().numpy())
    images, lmks = np.concatenate(images)[:n], np.concatenate(lmks)[:n]
    size = cfg.image_size
    warped, moved = [], []
    for img, lm in zip(images, lmks):
        ang, sc = rng.uniform(-0.3, 0.3), rng.uniform(0.85, 1.15)
        rot = sc * np.array([[np.cos(ang), -np.sin(ang)],
                             [np.sin(ang), np.cos(ang)]])
        c = np.array([size / 2, size / 2])
        t = c - rot @ c + rng.uniform(-0.1, 0.1, 2) * size
        m = np.concatenate([rot, t[:, None]], axis=1).astype(np.float32)
        warped.append(warp_affine(np.clip(img, 0, 1), m, size))
        moved.append(np.concatenate([lm, np.ones((68, 1))], 1) @ m.T)
    _write_faces(root, np.stack(warped), np.stack(moved))
    del bfm
    torch.cuda.empty_cache()


def _run_train(argv, cfg):
    """train.run on parsed argv with `cfg` as its default configuration,
    its standard output captured and echoed. Returns (report, printed
    lines)."""
    from facerecon_tpu_torch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), unittest.mock.patch.object(
            train, "default_config", lambda: cfg):
        report = train.run(train.parse_args(argv))
    text = buf.getvalue()
    print(text, end="")
    return report, text.splitlines()


def _loss_lines(lines):
    return [json.loads(x) for x in lines if x.startswith('{"step"')]


def check_train_driver(cfg, assets, tmp):
    """The train driver at full width on a folder of TRAIN_DIR_FACES
    rendered 224-px PNGs, each warped by a random similarity, with
    68-point side-cars: --data-dir --align 68pt --batch TRAIN_DIR_BATCH
    --chunk 2 --steps 4 --ckpt-dir, with cfg.checkpoint_every 2, the
    counters reset just before and read just after (one K2 and one K3
    launch a step, no K1: the source is on the host), and its first K2
    and K3 held against their plain versions on the arguments the step
    gave them; then a fresh trainer restored from
    the checkpoint equals it bit for bit (model, Adam, schedule, step 4),
    and --resume --steps 2 goes on to step 6 with every loss finite.
    Last, ms a step on the uint8 wire and on --wire-f32 (TRAIN_DIR_STEPS
    steps each, the driver's own rate after its warm-up). Returns the
    launch counts of the first run."""
    from facerecon_tpu_torch import train
    from facerecon_tpu_torch.checkpoint import CheckpointManager
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.pipeline import make_train_pipeline
    root, ck = os.path.join(tmp, "photos"), os.path.join(tmp, "train_ck")
    _photo_folder(cfg, assets, root, TRAIN_DIR_FACES)
    cfg2 = dataclasses.replace(cfg, checkpoint_every=2)
    base = ["--data-dir", root, "--align", "68pt", "--batch",
            str(TRAIN_DIR_BATCH),
            "--log-every", "1", "--device", DEVICE]
    with _recording("select_windows", "select_grad") as seen:
        _build.reset_launches()
        _, lines = _run_train(base + ["--chunk", "2", "--steps", "4",
                                      "--ckpt-dir", ck], cfg2)
        launches = dict(_build.LAUNCHES)
    if launches != _launches(raster_select=4, select_grad=4):
        raise AssertionError(f"the train driver launched {launches}")
    _hold_recorded(seen, f"train driver step 1 (batch {TRAIN_DIR_BATCH})")
    del seen
    logged = _loss_lines(lines)
    mgr = CheckpointManager(ck)
    # checkpoint_every counts iterations of --chunk steps: the save at
    # iteration 2 and the final one are both step 4
    if [x["step"] for x in logged] != [2, 4] or mgr.steps() != [4]:
        raise AssertionError(f"train driver: logged {logged}, saved "
                             f"{mgr.steps()}")

    # a fresh trainer restored from step 4 holds what was saved
    saved = mgr.restore()
    pipe = make_train_pipeline(cfg2, assets, device=DEVICE, seed=1)
    state = train.init_state(pipe, 2, seed=1)
    train.restore_state(mgr, pipe, state)
    if not (state.step == saved["step"] == 4
            and _same(pipe.model.state_dict(), saved["model"])
            and _same(state.optimizer.state_dict(), saved["optimizer"])
            and _same(state.scheduler.state_dict(), saved["scheduler"])):
        raise AssertionError("the restored trainer differs from the "
                             "checkpoint")
    print("train driver: the restored model, Adam and schedule equal "
          "step 4's checkpoint bit for bit")
    del pipe, state, saved
    torch.cuda.empty_cache()

    _, lines = _run_train(base + ["--chunk", "2", "--steps", "2",
                                  "--ckpt-dir", ck, "--resume"], cfg2)
    logged += _loss_lines(lines)
    if lines[0] != "resumed at step 4" or mgr.latest_step() != 6:
        raise AssertionError(f"resume: {lines[:2]}, saved {mgr.steps()}")
    if not all(np.isfinite(x[k]) for x in logged
               for k in ("photo", "landmark", "reg", "gamma", "total")):
        raise AssertionError(f"a non-finite training loss: {logged}")

    for wire in ("u8", "f32"):
        _, lines = _run_train(base + ["--steps", str(TRAIN_DIR_STEPS),
                                      "--log-every", str(TRAIN_DIR_STEPS)]
                              + (["--wire-f32"] if wire == "f32" else []),
                              cfg)
        rate = _loss_lines(lines)[-1]["faces_per_sec"]
        print(f"train driver, {wire} wire: {TRAIN_DIR_BATCH * 1e3 / rate:.2f} "
              f"ms/step ({rate} faces/s, batch {TRAIN_DIR_BATCH} from a PNG "
              f"folder, --align 68pt, "
              f"{TRAIN_DIR_STEPS} steps, the first 3 excluded) on "
              f"{_card_line()}")
    _driver_split(cfg, assets, root)
    return launches


def _busy_ms(fn):
    """(busy, wall): the device's busy time (ms) while fn() runs, the
    union of the kernels and copies in torch.profiler's trace
    (profile_trace.summarize, which raises when the trace holds no device
    event), and the host clock's ms from fn()'s start to the device's
    end, under the same profiler."""
    from torch.profiler import ProfilerActivity, profile
    from facerecon_tpu_torch import profile_trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return profile_trace.summarize(
        profile_trace.trace_events(prof))["busy_ms"], wall


def _driver_split(cfg, assets, root):
    """Where the train driver's step goes, each part alone on the main
    thread: the folder source (decode and align a batch), each wire's
    host half (host_wire, which the driver runs on its feeder thread) and
    device half (stage_images), and the training step on a batch already
    on the card, with the device's busy share of that step
    (torch.profiler)."""
    from facerecon_tpu_torch.data.folder import FolderDataset
    from facerecon_tpu_torch.pipeline import make_train_pipeline
    from facerecon_tpu_torch.train import (host_wire, init_state,
                                           make_train_step, stage_images)
    ds = FolderDataset(root, cfg, align="68pt", assets=assets)
    it = ds.batches(TRAIN_DIR_BATCH, seed=1)
    next(it)
    t0 = time.perf_counter()
    host = [next(it) for _ in range(4)]
    feed_ms = (time.perf_counter() - t0) * 1e3 / 4
    quant_ms, wire_ms = {}, {}
    for wire in ("u8", "f32"):
        t0 = time.perf_counter()
        sent = [host_wire(images, wire == "u8") for images, _, _ in host]
        quant_ms[wire] = (time.perf_counter() - t0) * 1e3 / len(host)

        def stage():
            for images in sent:
                stage_images(images, torch.device(DEVICE))
        stage()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage()
        torch.cuda.synchronize()
        wire_ms[wire] = (time.perf_counter() - t0) * 1e3 / len(host)
    pipe = make_train_pipeline(cfg, assets, device=DEVICE)
    state = init_state(pipe, 1000, seed=0)
    step = make_train_step(pipe)
    images = stage_images(host_wire(host[0][0]), pipe.device)
    lmk = torch.as_tensor(host[0][1], device=DEVICE)
    for _ in range(3):
        step(state, images, lmk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        step(state, images, lmk)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 8
    busy = _busy_ms(lambda: [step(state, images, lmk)
                             for _ in range(4)])[0] / 4
    print(f"train driver split (batch {TRAIN_DIR_BATCH}, each alone on the "
          f"main thread): folder source {feed_ms:.2f} ms a batch (PIL decode "
          f"+ 68pt align); the wire's host half (the feeder thread's) u8 "
          f"{quant_ms['u8']:.2f} ms, f32 {quant_ms['f32']:.2f} ms; its "
          f"device half (staging on the main thread) u8 "
          f"{wire_ms['u8']:.2f} ms, f32 "
          f"{wire_ms['f32']:.2f} ms; train step on a card batch "
          f"{step_ms:.2f} ms, device busy {busy:.2f} ms of it "
          f"({100 * busy / step_ms:.1f}%, torch.profiler) on {_card_line()}")
    del pipe, state
    torch.cuda.empty_cache()


def _same(a, b) -> bool:
    """Nested state dicts equal bit for bit (tensors compared on the
    CPU)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    return a == b


def _track(label, argv, want):
    """track.run on parsed argv at full width, inside a recording of its
    first K1, K2 and K3 calls, the counters reset just before and read
    just after; the launches must be `want`, and each recorded call is
    held against its plain version. Returns (report, launches)."""
    from facerecon_tpu_torch import track
    from facerecon_tpu_torch.ops import _build
    names = [w for w, k in _WRAPPERS.items() if want[k]]
    with _recording(*names) as seen:
        _build.reset_launches()
        rep = track.run(track.parse_args(argv + ["--device", DEVICE]))
        launches = dict(_build.LAUNCHES)
    if launches != want:
        raise AssertionError(f"{label} launched {launches}, not {want}")
    _hold_recorded(seen, label)
    torch.cuda.empty_cache()
    return rep, launches


def _track_launches(k1, steps):
    """K1 k1 times (the synthetic sequence's render, when k1 is 2, and the
    tracked one), K2 a step and once for the report, K3 a step; the
    geometry kernel for each no_grad render and for the synthetic
    sequence's ground-truth geometry."""
    return _launches(raster_shade=k1, raster_select=steps + 1,
                     select_grad=steps, geometry=k1 + 1 + (k1 == 2))


def check_track(cfg, assets, tmp):
    """The track driver at full width (README's command and two more):
      - joint: the synthetic sequence, TRACK_FRAMES frames, TRACK_STEPS
        refine steps (K1 twice: the sequence's render and the tracked
        one; K2 a step and once for the report; K3 a step); the loss
        falls;
      - sequential: SEQ_FRAMES frames x SEQ_STEPS steps at batch 1, with
        the device's busy share of a short run (torch.profiler);
      - --video: a TRACK_FRAMES-frame MJPG clip of rendered faces written
        with cv2 and a (T,68,2) landmark file, --align none; the decoded
        frames within VIDEO_MAE of the source, and the loss halves.
    Returns each run's launch counts."""
    from facerecon_tpu_torch import track
    from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
    from facerecon_tpu_torch.data.video import load_video
    from facerecon_tpu_torch.ops.geometry import device_bfm
    counts = {}
    rep, counts["track joint"] = _track(
        "track joint",
        ["--frames", str(TRACK_FRAMES), "--refine-steps", str(TRACK_STEPS)],
        _track_launches(2, TRACK_STEPS))
    print(f"track joint: {rep['refine_s'] * 1e3 / TRACK_STEPS:.3f} ms a "
          f"refine step ({TRACK_FRAMES} frames, {cfg.image_size} px, "
          f"{TRACK_STEPS} steps, the first included); loss "
          f"{rep['loss_first']:.5f} -> {rep['loss_last']:.5f}, PSNR "
          f"{rep['psnr_db']:.2f} dB, vertex MAE {rep['vertex_mae']:.5f}, "
          f"landmark RMSE {rep['landmark_rmse_px']:.3f} px; launches "
          f"{counts['track joint']} on {_card_line()}")
    if not (np.isfinite(rep["loss_last"])
            and rep["loss_last"] < rep["loss_first"]):
        raise AssertionError(f"track joint: the loss did not fall: {rep}")

    n_seq = SEQ_FRAMES * SEQ_STEPS
    rep, counts["track sequential"] = _track(
        "track sequential",
        ["--sequential", "--frames", str(SEQ_FRAMES), "--refine-steps",
         str(SEQ_STEPS)], _track_launches(2, n_seq))
    ms = rep["refine_s"] * 1e3 / n_seq
    bfm = device_bfm(assets, DEVICE)
    coeff = sample_coeffs(np.random.default_rng(3), cfg, 2)
    frames, lmk = render_batch(coeff, bfm, cfg)
    seq_fn = track.make_sequential_fn(cfg, 5)
    # the busy share from one run: a short sequential solve (2 frames x
    # 5 steps) under the profiler, its device time over its own wall
    busy, wall = (t / 10 for t in _busy_ms(
        lambda: seq_fn(coeff * 0.5, bfm, frames, lmk)))
    print(f"track sequential: {ms:.3f} ms a step at batch 1 ({SEQ_FRAMES} "
          f"frames x {SEQ_STEPS} steps); a profiled run of 2 frames x 5 "
          f"steps: {wall:.3f} ms a step, the device busy {busy:.3f} ms of "
          f"it ({100 * busy / wall:.1f}%, torch.profiler); "
          f"loss {rep['loss_first']:.5f} -> {rep['loss_last']:.5f}, PSNR "
          f"{rep['psnr_db']:.2f} dB, vertex MAE {rep['vertex_mae']:.5f}; "
          f"launches {counts['track sequential']}")
    if not np.isfinite([rep["loss_first"], rep["loss_last"]]).all():
        raise AssertionError(f"track sequential: {rep}")

    import cv2
    base = sample_coeffs(np.random.default_rng(9), cfg, 1)[0]
    seq = np.tile(base, (TRACK_FRAMES, 1))
    seq[:, cfg.coeff_split[2]] += 0.15 * np.sin(np.linspace(
        0, 2 * np.pi, TRACK_FRAMES, dtype=np.float32))
    frames, lmk = (t.cpu().numpy() for t in render_batch(seq, bfm, cfg))
    path = os.path.join(tmp, "clip.avi")
    lmk_path = os.path.join(tmp, "clip_lmk.npy")
    size = cfg.image_size
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25,
                         (size, size))
    if not vw.isOpened():
        raise AssertionError("cv2 cannot write an MJPG clip here")
    for img in frames:
        vw.write((np.clip(img, 0, 1) * 255).astype(np.uint8)[..., ::-1])
    vw.release()
    np.save(lmk_path, lmk)
    dec, _ = load_video(path, cfg, landmarks=lmk_path, align="none")
    mae = float(np.abs(dec - frames).mean())
    if not (dec.shape == frames.shape and mae < VIDEO_MAE):
        raise AssertionError(f"the decoded clip {dec.shape} differs from "
                             f"its source by {mae} (bar {VIDEO_MAE})")
    rep, counts["track video"] = _track(
        "track --video",
        ["--video", path, "--video-landmarks", lmk_path, "--align", "none",
         "--refine-steps", str(TRACK_STEPS)], _track_launches(1, TRACK_STEPS))
    print(f"track --video: decoded {dec.shape[0]} MJPG frames, mean |err| "
          f"{mae:.4f} against the source (bar {VIDEO_MAE}); "
          f"{rep['refine_s'] * 1e3 / TRACK_STEPS:.3f} ms a refine step; loss "
          f"{rep['loss_first']:.5f} -> {rep['loss_last']:.5f}, PSNR "
          f"{rep['psnr_db']:.2f} dB, landmark RMSE "
          f"{rep['landmark_rmse_px']:.3f} px; launches "
          f"{counts['track video']}")
    if not rep["loss_last"] < 0.5 * rep["loss_first"]:
        raise AssertionError(f"track --video: the loss did not halve: {rep}")
    del bfm, frames, lmk
    torch.cuda.empty_cache()
    return counts


def check_render512():
    """Config 5's render at 512 px: bench.render512 (default_config at
    image_size 512, focal scaled, tile_h 2, 8 columns, its own synthetic
    asset, R512_BATCH faces in microbatches of R512_MICRO through the
    inference render: one K1 launch a microbatch; 1 warm-up and REPS
    timed passes), the counters reset just before and read just after;
    the first microbatch's K1 call, all R512_MICRO images of it, held
    against its plain version (tri_id exact, color and bary 1e-6); then
    K1's ms a launch at that shape. Returns the launch counts."""
    from facerecon_tpu_torch import bench
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import rasterize as R
    with _recording("shade_windows", "band_windows") as seen:
        _build.reset_launches()
        payload, means = bench.render512(R512_BATCH, R512_MICRO, REPS,
                                         device=DEVICE)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    print(json.dumps(payload))
    want = (1 + REPS) * (R512_BATCH // R512_MICRO)
    if launches != _launches(raster_shade=want, geometry=want):
        raise AssertionError(f"render512 launched {launches}")
    if not bool(torch.isfinite(means).all()):
        raise AssertionError("render512: non-finite images")
    err = _hold_recorded(seen, "render512")["raster_shade"]
    (win, rec), kw = seen["shade_windows"]
    cover = float((R.shade_windows(win, rec, **kw)[0] >= 0).float().mean())
    k1_ms = _time_ms(lambda: R.shade_windows(win, rec, **kw), REPS)
    print(f"render512: {payload['value']:.1f} faces/s (batch {R512_BATCH} "
          f"in microbatches of {R512_MICRO}, 512 px, tile_h 2 x 8 columns, "
          f"{REPS} timed passes after 1); K1 {k1_ms:.3f} ms a launch of "
          f"{R512_MICRO}; K1 held on all {R512_MICRO} images of microbatch 1 "
          f"(coverage {cover:.3f}) max|err| {err:.3g}; launches {launches} on "
          f"{_card_line()}")
    del seen, win, rec, means
    torch.cuda.empty_cache()
    return launches


def _raster_bound(name, win, kw, got, issued_images=None):
    """(_tests_made's counts, bound_ms, bound_by) of rasterizer `name` on
    these windows, launched with kw, whose outputs are got."""
    t = _tests_made(win, kw["tile_h"], kw["n_cols"], kw["width"],
                    issued_images)
    bound_ms, bound_by = _bound(
        _raster_bytes(win, got, _raster_kernels()[name][3], kw["n_cols"],
                      kw["n_faces"]), t["needed_ops"],
        f"{name} (tile_h {kw['tile_h']})", t["group_ops"])
    return t, bound_ms, bound_by


def _rasterizers_on(win, rec, kw, t, where):
    """K1 and K4 on a K2 call's windows and records: each held against
    its plain version on the first RENDER_HOLD_IMAGES images, timed a
    launch on all of them, and bounded on those windows' tests t
    (_tests_made's, the same for the three kernels) and its own bytes;
    one line."""
    parts = []
    n = RENDER_HOLD_IMAGES
    for name in ("raster_shade", "raster_pos"):
        kernel, plain, _, fields = _raster_kernels()[name]
        got = kernel(win, rec, **kw)
        torch.cuda.synchronize()
        err = _hold(name, tuple(g[:n] for g in got),
                    plain(_head(win, n), rec[:n], **kw),
                    f"{where}, first {n} images")
        ms = _time_ms(lambda: kernel(win, rec, **kw), REPS)
        bound_ms, bound_by = _bound(
            _raster_bytes(win, got, fields, kw["n_cols"], kw["n_faces"]),
            t["needed_ops"], f"{name} (tile_h {kw['tile_h']})")
        parts.append(f"{name} {ms:.4f} ms a launch, max|err| {err:.3g}, "
                     f"bound {bound_ms:.4f} ms by {bound_by}")
        del got
    print(f"{where}: on K2's windows and records, {'; '.join(parts)}")


def check_render_bench():
    """The render-chain benchmark (render_bench, the twin of
    benchmarks/render_bench.py) through its own functions at its default
    batch (64) on default_config's asset, for each of RENDER_RUNS: 224 px
    (tile_h 2 x 7 columns) fwd and fwd+bwd, and 512 px (tile_h 1 x 7
    columns of 80 px) fwd+bwd; reps and inner lowered to RENDER_REPS and
    RENDER_INNER. For each run, the counters reset just before and read
    just after: (1 + 3 reps) x inner K2 launches, as many K3 with --bwd,
    and nothing else; the chains' sums finite; the first K2 and K3 calls
    held whole against their plain versions (K2 exact, K3 within 1e-5 x
    max |ref| and bitwise over two launches); ms a batch and faces/s;
    K2's and K3's ms a launch on the recorded calls, K2's tests made (in
    the tile) and issued (the micro-tiles' whole groups) and its bound,
    K3's bound and index_add_ (_select_grad_times); at 512 px, K1 and K4
    timed and bounded on K2's windows and held on their first images
    (_rasterizers_on); the peak of allocated memory. Returns the
    launches summed."""
    from facerecon_tpu_torch import render_bench
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import rasterize as R
    total = collections.Counter()
    batch = render_bench.parse_args([]).batch
    for size, bwd in RENDER_RUNS:
        t0 = time.perf_counter()
        tile_h = render_bench.default_tile_h(size)
        tag = "fwd+bwd" if bwd else "fwd"
        where = f"render_bench {size} px {tag}"
        cfg, bfm, coeffs, target = render_bench.setup(size, batch, tile_h,
                                                      DEVICE)
        one = render_bench.make_one(cfg, bfm, target, bwd)
        names = ("select_windows", "select_grad") if bwd else (
            "select_windows",)
        torch.cuda.reset_peak_memory_stats()
        with _recording(*names) as seen:
            _build.reset_launches()
            res = render_bench.run(one, coeffs, RENDER_REPS, RENDER_INNER,
                                   tag)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = (1 + 3 * RENDER_REPS) * RENDER_INNER
        want = _launches(raster_select=n, select_grad=n if bwd else 0,
                         geometry=0 if bwd else n)
        if launches != want:
            raise AssertionError(f"{where} launched {launches}, not {want}")
        if not (np.isfinite(res["first_sum"]) and np.isfinite(res["sum"])):
            raise AssertionError(f"{where}: non-finite sums {res}")
        total.update(launches)
        t_hold = time.perf_counter()
        _hold_recorded(seen, where)
        t_hold = time.perf_counter() - t_hold
        (win, rec), kw = seen["select_windows"]
        got = R.select_windows(win, rec, **kw)
        k2_ms = _time_ms(lambda: R.select_windows(win, rec, **kw), REPS)
        t, bound_ms, bound_by = _raster_bound("raster_select", win, kw,
                                              got)
        del got
        if size == 512:
            _rasterizers_on(win, rec, kw, t, where)
        k3 = ""
        if bwd:
            args, gkw = seen["select_grad"]
            k3_ms = _select_grad_times(*args, gkw["rows"], gkw["tile_h"],
                                       where)["ms"]
            k3 = f", K3 {k3_ms:.4f} ms a launch"
        _, ms, faces_s = res["runs"][-1]
        col_w = R.col_width(size, cfg.raster_cols)
        print(f"{where}: batch {batch}, tile_h {tile_h} x "
              f"{cfg.raster_cols} columns of {col_w} px, reps "
              f"{RENDER_REPS} and inner {RENDER_INNER} (the reference's "
              f"3 and 8 lowered); {ms:.3f} ms/{batch} -> "
              f"{faces_s:.1f} faces/s (reps={2 * RENDER_REPS}); K2 "
              f"{k2_ms:.4f} ms a launch{k3}; "
              f"{_tests_line('K2', t)}; K2 "
              f"bound {bound_ms:.4f} ms by {bound_by}; plain holds "
              f"{t_hold:.1f} s; peak allocated {peak:.2f} GiB; launches "
              f"{launches}; {time.perf_counter() - t0:.1f} s on "
              f"{_card_line()}")
        del seen, win, rec, res, one, cfg, bfm, coeffs, target
        torch.cuda.empty_cache()
    return {k: total[k] for k in _build.KERNELS}


def check_raster_bench():
    """The rasterizer benchmark (raster_bench, the twin of
    benchmarks/raster_bench.py) through its own functions at its
    defaults (batch 64, 224 px, 5 reps): default_config's vertices, tile_h
    8 x one 224-px column, the asset's own face order, without and with
    back-face culling. For each, the counters reset just before and read
    just after: 1 + 3 x reps K4 launches and
    nothing else; the first call's sum equals the last call's; the first
    K4 call held whole against its plain version (exact); ms a batch and
    faces/s, and K4's ms a launch (without culling also its tests made
    and issued and its bound). Then --check (rasterize_batch on the
    card against a CPU copy on the first face): a mismatch of 0, one K4
    launch. Returns the launches summed."""
    from facerecon_tpu_torch import raster_bench
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import rasterize as R
    total = collections.Counter()
    args = raster_bench.parse_args([])
    vndc, faces = raster_bench.geometry(args.batch, DEVICE)
    s = args.size
    for cull in (False, True):
        where = f"raster_bench{' --cull' if cull else ''}"
        pos_fn = raster_bench.make_pos_fn(s, args.tileh, cull)
        with _recording("pos_windows") as seen:
            _build.reset_launches()
            res = raster_bench.run(pos_fn, vndc, faces, args.reps)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        want = _launches(raster_pos=1 + 3 * args.reps)
        if launches != want:
            raise AssertionError(f"{where} launched {launches}, not {want}")
        if res["chk"] != int(res["out"].sum()):
            raise AssertionError(f"{where}: the first call's sum "
                                 f"{res['chk']} is not the last call's")
        total.update(launches)
        t_hold = time.perf_counter()
        _hold_recorded(seen, where)
        t_hold = time.perf_counter() - t_hold
        (win,), kw = seen["pos_windows"]
        k4_ms = _time_ms(lambda: R.pos_windows(win, **kw), REPS)
        bound = ""
        if not cull:
            t, bound_ms, bound_by = _raster_bound(
                "raster_pos", win, kw, R.pos_windows(win, **kw),
                RASTER_COUNT_IMAGES)
            bound = (f"; {_tests_line('K4', t)}, bound "
                     f"{bound_ms:.4f} ms by {bound_by}")
        cover = float((res["out"] >= 0).float().mean())
        _, ms, faces_s = res["runs"][-1]
        print(f"{where}: batch {args.batch}, tile_h {args.tileh} x one "
              f"{s}-px column, the asset's face order, max bn "
              f"{int(win.bn.max())}, coverage {cover:.4f}; {ms:.3f} "
              f"ms/{args.batch} -> {faces_s:.1f} faces/s "
              f"(reps={2 * args.reps}); K4 {k4_ms:.4f} ms a launch"
              f"{bound}; plain hold {t_hold:.1f} s; launches {launches} on "
              f"{_card_line()}")
        del seen, win, res
    _build.reset_launches()
    mismatch = raster_bench.check(vndc, faces, s)
    launches = dict(_build.LAUNCHES)
    if mismatch != 0 or launches != _launches(raster_pos=1):
        raise AssertionError(f"raster_bench --check: mismatch {mismatch}, "
                             f"launches {launches}")
    total.update(launches)
    print(f"raster_bench --check: mismatch vs plain: {mismatch} / {s * s}")
    del vndc, faces
    torch.cuda.empty_cache()
    return {k: total[k] for k in _build.KERNELS}


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
    non-finite time or sum; on any launch of a port kernel in the phase
    (counters reset just before, read just after); on the two stems
    differing by more than PROBE_STEM_BF16 x max |ref| in bf16 or
    PROBE_STEM_F32 x max |ref| in f32; on pool_slices agreeing with
    pool_rw (the reference's two forms differ, and the twin keeps both);
    on the 1-pass scatter-min of the first image differing from numpy's
    minimum.at on its CPU copy; on a gather form differing from its CPU
    result (the first image, PROBE_GATHER x max |ref|: exact but for the
    adjacency's sums). Returns the launches."""
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
    with torch.no_grad():
        for dt, tol in ((torch.bfloat16, PROBE_STEM_BF16),
                        (torch.float32, PROBE_STEM_F32)):
            y4 = cnn_micro_probe.conv4(d["img"], d["w4"].to(dt), d["b0"])
            y7 = cnn_micro_probe.conv7(d["img"], d["w7"].to(dt), d["b0"])
            scale = float(y7.float().abs().max())
            err = float((y4.float() - y7.float()).abs().max())
            print(f"cnn_micro_probe stems, {str(dt)[6:]}: max|conv4 - "
                  f"conv7| {err:.3g} of max|conv7| {scale:.3g} (bound "
                  f"{tol:.3g} x max)")
            if not (scale > 0 and err <= tol * scale):
                raise AssertionError(f"the stems differ in {dt}: {err} > "
                                     f"{tol} x {scale}")
        differ = float((cnn_micro_probe.pool_rw(y7)
                        != cnn_micro_probe.pool_slices(y7)).float().mean())
    print(f"cnn_micro_probe pools: pool_rw and pool_slices differ at "
          f"{differ:.4f} of the outputs (the reference's two forms)")
    if not differ > 0.5:
        raise AssertionError(f"pool_slices agrees with pool_rw ({differ})")
    del d, y4, y7
    torch.cuda.empty_cache()
    _probe_cases("cnn_micro_probe", cases, cnn_micro_probe.INNER,
                 cnn_micro_probe.REPS, t0, card)

    t0 = time.perf_counter()
    d = gather_probe.make_inputs(gather_probe.knobs()["batch"], DEVICE)
    cases = gather_probe.run(d)
    worst = 0.0
    with torch.no_grad():
        for tag, form, x, i in gather_probe.CASES:
            ix = d[i] if i != "bidx" else d[i][:1]
            got = form(d[x][:1], ix)
            want = form(d[x][:1].cpu(), ix.cpu())
            for g, w in zip(got, want):
                err = float((g.cpu() - w).abs().max())
                worst = max(worst, err / float(w.abs().max()))
                if err > PROBE_GATHER * float(w.abs().max()):
                    raise AssertionError(f"gather {tag!r} differs from its "
                                         f"CPU result by {err}")
    print(f"gather_probe forms on the first image against the CPU: worst "
          f"max|diff| {worst:.3g} of max|ref|")
    del d
    torch.cuda.empty_cache()
    _probe_cases("gather_probe", cases, gather_probe.INNER,
                 gather_probe.REPS, t0, card)

    t0 = time.perf_counter()
    k = scatter_probe.knobs()
    idx, zb, ids = scatter_probe.make_inputs(k["batch"], k["m"], k["size"],
                                             DEVICE)
    cases = scatter_probe.run(idx, zb, ids, k["size"], k["batch"])
    hw = k["size"] ** 2
    with torch.no_grad():
        gi = scatter_probe.flat_index(idx, hw, torch.zeros((), device=DEVICE))
        got = scatter_probe.scatter_min(gi, zb.reshape(-1),
                                        k["batch"] * hw)[:hw].cpu().numpy()
    ref = np.full(hw, scatter_probe.INT32_MAX, np.int64)
    np.minimum.at(ref, idx[0].cpu().numpy(), zb[0].cpu().numpy())
    if not np.array_equal(got, ref):
        raise AssertionError("the 1-pass scatter-min of image 0 differs "
                             "from numpy's minimum.at")
    print(f"scatter_probe: the 1-pass scatter-min of image 0 equals numpy's "
          f"minimum.at ({int((ref < scatter_probe.INT32_MAX).sum())} of "
          f"{hw} px hit)")
    del idx, zb, ids, gi
    torch.cuda.empty_cache()
    _probe_cases("scatter_probe", cases, scatter_probe.INNER,
                 scatter_probe.REPS, t0, card)

    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"the probes launched port kernels: {launches}")
    return launches

def check_entry():
    """graft_entry.entry() on the card: fn(*args) (the BN model as the
    reference initialises it, zeros (8, 224, 224, 3), the differentiable
    render) with the counters reset just before and read just after: one
    K2 launch and nothing else, the reference test's shapes
    (tests/test_graft_entry.py), finite outputs; its K2 call held
    against the plain version. Returns the launch counts."""
    from facerecon_tpu_torch.graft_entry import entry
    from facerecon_tpu_torch.ops import _build
    fn, args = entry(DEVICE)
    with _recording("select_windows") as seen:
        _build.reset_launches()
        coeffs, image, lmk = fn(*args)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    if launches != _launches(raster_select=1):
        raise AssertionError(f"entry() launched {launches}")
    if not (coeffs.shape == (8, 257) and image.shape == (8, 224, 224, 3)
            and lmk.shape == (8, 68, 2)):
        raise AssertionError(f"entry() shapes {coeffs.shape}, {image.shape}, "
                             f"{lmk.shape}")
    if not all(bool(torch.isfinite(t).all()) for t in (coeffs, image, lmk)):
        raise AssertionError("entry(): non-finite outputs")
    print(f"entry(): coefficients {tuple(coeffs.shape)}, image "
          f"{tuple(image.shape)}, landmarks {tuple(lmk.shape)}, finite; "
          f"|coeff| max {float(coeffs.detach().abs().max()):.3g}; launches "
          f"{launches}")
    _hold_recorded(seen, "entry()")
    del fn, args, coeffs, image, lmk, seen
    torch.cuda.empty_cache()
    return launches


def _read_trace(where, events, want):
    """One trace's events through profile_trace.summarize: prints the
    device's busy share of the window, its 10 device ops with the most
    time and its 5 longest idle gaps (each with the host op open as it
    began); fails unless the port's kernels have exactly
    `want` device events (kernel -> events, the others none)."""
    from facerecon_tpu_torch import profile_trace
    s = profile_trace.summarize(events)
    want = {k: want.get(k, 0) for k in s["kernels"]}
    if s["kernels"] != want:
        raise AssertionError(f"trace, {where}: the port's kernels have "
                             f"{s['kernels']} device events, not {want}")
    print(f"trace, {where}: device busy {s['busy_ms']:.3f} ms of a "
          f"{s['window_ms']:.3f} ms window ({100 * s['busy_share']:.1f}%; "
          f"first host op to last device event); the port's kernels' "
          f"device events {s['kernels']}; on {_card_line()}")
    for name, n, ms, share in s["top"]:
        short = name.replace("void ", "").replace("at::native::", "")
        print(f"  device op {ms:9.3f} ms {100 * share:5.1f}% x{n:<5d} "
              f"{short[:110]}")
    for ms, op in s["gaps"]:
        print(f"  idle gap {ms:9.3f} ms, host in {op}")


def check_trace(cfg, assets, tmp):
    """The trace endpoint (profile_trace, the twin of
    benchmarks/profile_trace.py) and the main paths, each read through
    profile_trace.summarize (_read_trace):
      - the twin through its main() at its defaults (batch 32, 3 traced
        calls), then through trace() at TRAIN_BATCH on this phase's
        assets, each into its own --out under tmp: trace.json parses; K2
        launched 1 + 3 times and nothing else, 3 K2 device events in the
        trace; the warm-up call's K2 held against its plain version
        (every traced call repeats it on the same inputs);
      - one headline microbatch of MICRO (bench.headline_pass on
        bench.headline_pipeline) after a warm-up: one K1 device event;
      - one bench.train step at TRAIN_BATCH (bench.train_inputs) after a
        warm-up: one K2 and one K3 device event.
    The counters are reset just before each run and read just after.
    Returns the phase's launch counts, summed."""
    from torch.profiler import ProfilerActivity, profile
    from facerecon_tpu_torch import bench, profile_trace
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.pipeline import make_train_pipeline
    from facerecon_tpu_torch.train import init_state, make_train_step
    total = collections.Counter()
    defaults = profile_trace.parse_args([])
    steps = defaults.steps
    for batch in (defaults.batch, TRAIN_BATCH):
        out = os.path.join(tmp, f"trace_{batch}")
        # K2's inputs are copied in the warm-up, outside the profiler's
        # window; the traced calls repeat it on the same inputs
        with _recording("select_windows") as seen:
            _build.reset_launches()
            if batch == defaults.batch:     # the command line as it stands
                path, _ = profile_trace.main(["--out", out, "--device",
                                              DEVICE])
            else:                           # on this phase's assets
                path, _ = profile_trace.trace(out, batch, steps, DEVICE,
                                              cfg, assets)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        if launches != _launches(raster_select=1 + steps,
                                 geometry=1 + steps):
            raise AssertionError(f"the twin at batch {batch} launched "
                                 f"{launches}")
        total.update(launches)
        _read_trace(f"the twin, batch {batch}, {steps} calls",
                    profile_trace.load_events(path),
                    _launches(raster_select=steps, geometry=steps))
        _hold_recorded(seen, f"the twin's warm-up call (batch {batch})")
        del seen
        torch.cuda.empty_cache()

    def traced(where, one, read, want):
        """one() as a warm-up, then once under the profiler, ended by a
        host read of read(its outputs)."""
        _build.reset_launches()
        float(read(one()))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            float(read(one()))
        launches = dict(_build.LAUNCHES)
        doubled = {k: 2 * n for k, n in want.items()}
        if launches != doubled:
            raise AssertionError(f"{where} launched {launches}, not "
                                 f"{doubled} (a warm-up and a traced run)")
        total.update(launches)
        _read_trace(where, profile_trace.trace_events(prof), want)

    pipe = bench.headline_pipeline(cfg, assets, DEVICE)
    images = torch.from_numpy(bench.headline_images(
        MICRO, cfg.image_size)).to(DEVICE)
    traced(f"one headline microbatch of {MICRO}",
           lambda: bench.headline_pass(pipe, images, MICRO),
           lambda out: out[1].sum(), _launches(raster_shade=1, geometry=1))
    del pipe, images
    torch.cuda.empty_cache()

    pipe = make_train_pipeline(cfg, assets, device=DEVICE)
    state = init_state(pipe, 1000, seed=0)
    step = make_train_step(pipe)
    images, lmk = (torch.from_numpy(x[0]).to(DEVICE) for x in
                   bench.train_inputs(1, TRAIN_BATCH, cfg.image_size))
    traced(f"one train step at batch {TRAIN_BATCH}",
           lambda: step(state, images, lmk), lambda parts: parts["total"],
           _launches(raster_select=1, select_grad=1))
    del pipe, state, step, images, lmk
    torch.cuda.empty_cache()
    return {k: total[k] for k in _build.KERNELS}


def check_data_parallel(cfg, assets, tmp):
    """Data parallelism on the card (one card, so world size 1; sizes
    above 1 are held on the CPU by tests/test_torch_parallel*.py):
    graft_entry.dryrun_multichip(1) over NCCL; then two train steps
    (bf16 ResNet-50, batch DP_BATCH) inside a world-size-1 NCCL group
    against the same steps with no group, from the same weights and
    batch, with cuDNN held to its deterministic algorithms: every
    parameter, buffer and loss part bit for bit equal."""
    import torch.distributed as dist
    from facerecon_tpu_torch.graft_entry import dryrun_multichip
    from facerecon_tpu_torch.parallel import mesh
    from facerecon_tpu_torch.pipeline import make_train_pipeline
    from facerecon_tpu_torch.train import init_state, make_train_step
    t0 = time.perf_counter()
    loss = dryrun_multichip(1)
    print(f"dryrun_multichip(1) over NCCL: loss {loss:.4f} "
          f"({time.perf_counter() - t0:.1f} s, the spawned process's "
          f"start included)")
    gen = torch.Generator().manual_seed(21)
    s = cfg.image_size
    images = torch.rand((DP_BATCH, s, s, 3), generator=gen).to(DEVICE)
    lmk = (torch.rand((DP_BATCH, 68, 2), generator=gen) * s).to(DEVICE)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for grouped in (False, True):
            if grouped:
                mesh.init(DEVICE, world_size=1, rank=0,
                          init_method="file://" + os.path.join(tmp, "nccl"))
            try:
                pipe = make_train_pipeline(cfg, assets, device=DEVICE)
                state = init_state(pipe, total_steps=2, seed=0)
                head = pipe.model.head.weight
                with torch.no_grad():    # a head that passes a gradient
                    head.copy_(2e-3 * torch.randn(
                        head.shape, generator=torch.Generator().manual_seed(
                            1)))
                step = make_train_step(pipe)
                parts = [step(state, images, lmk) for _ in range(2)]
                torch.cuda.synchronize()
                runs.append(([{k: v.cpu() for k, v in p.items()}
                              for p in parts],
                             {k: v.cpu() for k, v in
                              pipe.model.state_dict().items()}))
                del pipe, state, step, head
            finally:
                mesh.close()
    finally:
        torch.backends.cudnn.deterministic = was
    if dist.is_initialized():
        raise AssertionError("the NCCL group outlived its phase")
    (p0, s0), (p1, s1) = runs
    if not (_same(p0, p1) and _same(s0, s1)):
        raise AssertionError("the world-size-1 NCCL train step differs "
                             "from the plain step")
    print(f"data parallel: 2 train steps (batch {DP_BATCH}) in a world-size-1 "
          f"NCCL group equal the plain steps bit for bit ({len(s0)} tensors, "
          f"loss {float(p1[-1]['total']):.5f})")
    torch.cuda.empty_cache()


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
    measured = {"raster_shade": _check_raster("raster_shade", MICRO, cfg,
                                              assets, rng)[0]}
    measured["raster_select"], main_select = _check_raster(
        "raster_select", TRAIN_BATCH, cfg, assets, rng)
    measured["select_grad"] = check_select_grad(cfg, assets, main_select)
    del main_select
    torch.cuda.empty_cache()
    measured["raster_pos"] = _check_raster("raster_pos", MICRO, cfg, assets,
                                           rng)[0]
    measured["binning"] = _timed("binning", check_binning, cfg, assets)
    measured["geometry"] = _timed("geometry", check_geometry, cfg, assets)
    measured["raster_texture"], texture_launches = _timed(
        "texture", check_texture)
    check_wide_band(cfg, assets)
    _timed("band sweep", check_band_sweep, cfg, assets)
    launches = check_end_to_end(cfg, assets)
    train_launches = check_training(cfg, assets)
    contract_launches = check_contract(cfg, assets)
    check_evaluate()
    _timed("floor", check_floor, cfg, assets)
    measured["ctz_walk"], walk_launches = _timed("ctz_walk", check_ctz_walk)
    tmp = tempfile.mkdtemp()
    try:
        driver_launches = {
            "fit": _timed("fit", check_fit, cfg, assets, tmp),
            "train driver": _timed("train driver", check_train_driver, cfg,
                                   assets, tmp),
            "infer": _timed("infer", check_infer, cfg, assets, tmp)}
        driver_launches.update(_timed("track", check_track, cfg, assets,
                                      tmp))
        driver_launches["render512"] = _timed("render512", check_render512)
        driver_launches["render_bench"] = _timed("render_bench",
                                                 check_render_bench)
        driver_launches["raster_bench"] = _timed("raster_bench",
                                                 check_raster_bench)
        driver_launches["probes"] = _timed("probes", check_bench_probes)
        driver_launches["entry"] = _timed("entry", check_entry)
        driver_launches["trace"] = _timed("trace", check_trace, cfg, assets,
                                          tmp)
        _timed("data parallel", check_data_parallel, cfg, assets, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches.update(raster_select=train_launches["raster_select"],
                    select_grad=train_launches["select_grad"],
                    raster_pos=contract_launches["raster_pos"],
                    ctz_walk=walk_launches["ctz_walk"],
                    raster_texture=texture_launches["raster_texture"],
                    binning=launches["bin_setup"]
                    + train_launches["bin_setup"]
                    + contract_launches["bin_setup"]
                    + texture_launches["bin_setup"])

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
                    "coeffs_to_geometry, facerecon_tpu/ops/sh.py illuminate)"}
    kernels = [dict(
        name=name, route="cuda",
        source=f"facerecon_tpu_torch/csrc/{name}.cu",
        replaces=replaces[name], launches=launches[name],
        max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
        bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=m.get("library_ms")) for name, m in measured.items()]
    for phase, n in driver_launches.items():
        print(f"{phase} launches: raster_shade {n['raster_shade']}, "
              f"raster_select {n['raster_select']}, select_grad "
              f"{n['select_grad']}, raster_pos {n['raster_pos']}, "
              f"bin_setup {n['bin_setup']}, bin_windows "
              f"{n['bin_windows']}, geometry {n['geometry']}")
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
