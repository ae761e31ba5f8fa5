#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (facerecon_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit; TF32 off.
  2. build: compiles every kernel of the port from csrc/ with nvcc.
  3. kernels: each kernel against its plain PyTorch version at full width
     (default config: 224 px, synthetic BFM with 70,688 faces). The
     rasterizers K1 (raster_shade) and K2 (raster_select) on the asset's
     raster row order at the main path's batch and on a shuffled row
     order (windows beyond the 64-chunk mask); K3 (select_grad) on K2's
     winner rows with a cotangent drawn from a seed, twice (bitwise
     deterministic); K4 (raster_pos) on both row orders as K1 and K2
     (tri_id, depth and winner row exactly equal). Times each kernel and
     its plain version.
  4. inference main path: Pipeline.reconstruct with the bf16 ResNet-50.
     A checked small batch (finite outputs, coverage, one K1 launch per
     call, agreement with the same float32 pipeline run on the CPU), a
     stage split, then batch 256 in microbatches of 128, timed, with the
     launch counters reset just before and read just after.
  5. training main path: the BatchNorm ResNet-50 in bf16, 224 px, batch
     128, random images and landmarks (as bench.py's train mode): a stage
     split, then 1 warm-up and 5 timed steps with the counters reset just
     before and read just after (one K2 and one K3 launch a step, finite
     loss and gradients), then 10 steps on one rendered batch of 8, whose
     loss must fall.
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
     chunk added.
  8. K6 (ctz_walk): the live-chunk walk probe against its plain version
     at benchmarks/ctzloop_probe.py's shape (2,048 programs, 4/8/16/32
     live bits), exactly equal, then timed (counters reset just before):
     ns per live chunk.
  9. prints the per-kernel JSON line, the card line, and as the last line
     {"ok": true, "device": {...}}.
Uses random weights from a seed and random images, as bench.py does.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

MICRO = 128          # inference main-path microbatch
BATCH = 256          # images per timed inference step
REPS = 5             # timed steps (inference and training)
TRAIN_BATCH = 128    # training main-path batch (bench.py's train mode)
FIT_STEPS = 10       # loss-decrease check: steps on one batch of CHECK_BATCH
CHECK_BATCH = 8      # shuffled-order kernel check and checked e2e batch
H100_BYTES_S = 3.35e12   # HBM rate, H100 SXM data sheet
H100_F32_S = 67e12       # float32 rate outside the tensor cores
PAIR_FLOPS = 15      # f32 ops per pixel x triangle test (2 sub, 3 x 2 mul
                     # + 2 add, 1 add), comparisons not counted
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
WALK_PROGS = 2048    # K6: benchmarks/ctzloop_probe.py's shape
WALK_LIVE = (4, 8, 16, 32)
WALK_REPORTED = 8    # live bits of the K6 line in the kernels JSON
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


def _bound(n_bytes: int, n_ops: int, name: str):
    """(bound_ms, bound_by) for moving n_bytes and doing n_ops f32 ops."""
    t_bytes = n_bytes / H100_BYTES_S * 1e3
    t_ops = n_ops / H100_F32_S * 1e3
    print(f"{name} bound inputs: {n_bytes} bytes -> {t_bytes:.4f} ms; "
          f"{n_ops} f32 ops -> {t_ops:.4f} ms")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    the outputs after tri_id, whether the kernel reads the records). The
    wrappers and plain versions all take (win, rec, **kw). K2's sel is a
    copy of record values and K4 keeps the plain version's float32
    order, so both are held exactly."""
    from facerecon_tpu_torch.ops import rasterize as R
    return {
        "raster_shade": (R.shade_windows, R.shade_windows_reference,
                         _compare_shade, True),
        "raster_select": (R.select_windows, R.select_windows_reference,
                          _compare_exact("raster_select",
                                         ((1, "row"), (2, "sel"))), True),
        "raster_pos": (lambda win, rec, **kw: R.pos_windows(win, **kw),
                       lambda win, rec, **kw: R.pos_windows_reference(
                           win, **kw),
                       _compare_exact("raster_pos",
                                      ((1, "zbuf"), (2, "row"))), False),
    }


def _hold(name, got, ref, where) -> float:
    """A rasterizer's outputs against its plain version's: tri_id exactly
    equal, then the kernel's own compare. Returns the max |err|."""
    if not torch.equal(got[0], ref[0]):
        bad = int((got[0] != ref[0]).sum())
        raise AssertionError(f"{name} tri_id differs from the plain "
                             f"version at {bad} pixels ({where})")
    return _raster_kernels()[name][2](got, ref, where)


def _head(win, n: int):
    """The windows of the first n images."""
    return type(win)(*(t[:n] for t in win))


def _check_raster(name, main_batch, cfg, assets, rng):
    """A rasterizer kernel against its plain version on both row orders.
    Returns the kernel line's numbers at the main path's shapes and the
    (windows, records, outputs) of the asset-order batch."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
    kernel, plain, _, reads_records = _raster_kernels()[name]
    bfm = device_bfm(assets, DEVICE)
    s = cfg.image_size
    kw = dict(height=s, width=s, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              n_faces=assets.n_faces)
    result, max_err, main = {}, 0.0, None
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
            inputs = (win.setup, win.blo, win.bn, win.cmask) + (
                (rec,) if reads_records else ())
            bound_ms, bound_by = _bound(_nbytes(*inputs, *got),
                                        pairs * PAIR_FLOPS, name)
            result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
            main = (win, rec, got)
        else:
            del rec, win, got, ref
    del bfm
    torch.cuda.empty_cache()
    return dict(result, max_abs_err=max_err), main


def check_select_grad(cfg, main):
    """K3 against its plain version on K2's winner rows (batch 128, asset
    order) with a cotangent drawn from a seed: max |diff| <= 1e-5 x max
    |ref|, and two launches bitwise equal. library_ms is one index_add_
    of the same sums (the plain version's core)."""
    from facerecon_tpu_torch.ops import rasterize as R
    win, rec, (_, row, _) = main
    bsz, height, width = row.shape
    rows = rec.shape[2]
    g = torch.randn((bsz, R._SEL, height, width), device=DEVICE,
                    generator=torch.Generator(DEVICE).manual_seed(5))
    kw = dict(rows=rows, tile_h=cfg.tile_h)
    got = R.select_grad(row, g, win.blo, win.bn, **kw)
    again = R.select_grad(row, g, win.blo, win.bn, **kw)
    torch.cuda.synchronize()
    ref = R.select_grad_reference(row, g, win.blo, win.bn, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("select_grad is not deterministic: two "
                             "launches differ")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not (scale > 0 and err <= 1e-5 * scale):
        raise AssertionError(f"select_grad differs from the plain version "
                             f"by {err} (max |ref| {scale})")
    ms = _time_ms(lambda: R.select_grad(row, g, win.blo, win.bn, **kw),
                  reps=20)
    plain_ms = _time_ms(lambda: R.select_grad_reference(
        row, g, win.blo, win.bn, **kw), reps=1, warmup=0)
    hit = row >= 0
    src = g[:, :R._GRAD].permute(0, 2, 3, 1)[hit].contiguous()
    dst = (row.to(torch.int64) + torch.arange(
        bsz, device=DEVICE)[:, None, None] * rows)[hit]
    acc = torch.zeros((bsz * rows, R._GRAD), device=DEVICE)
    library_ms = _time_ms(lambda: acc.index_add_(0, dst, src), reps=20)
    # the cotangent is needed only at covered pixels: a background pixel
    # has no winner row and its g is never read
    n_hit = int(hit.sum())
    bound_ms, bound_by = _bound(
        _nbytes(row, win.blo, win.bn, got) + n_hit * R._GRAD * 4,
        n_hit * R._GRAD, "select_grad")
    print(f"select_grad batch={bsz} rows={rows} covered px={n_hit} "
          f"kernel={ms:.4f} ms plain={plain_ms:.2f} ms index_add_="
          f"{library_ms:.4f} ms max|err|={err:.3g} (max|ref| {scale:.3g}; "
          f"two launches bitwise equal)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, max_abs_err=err)


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
              f"{col_w} px, {cfg.tile_h * col_w} threads a block, seeds "
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
    if launches != dict(launches, raster_pos=len(outs), raster_shade=0,
                        raster_select=0, select_grad=0, ctz_walk=0):
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


def check_floor(cfg, assets):
    """K5: K1, K2 and K4 alone on inputs precomputed once, at
    benchmarks/floor_probe.py's defaults, with the real chunk masks and
    with every mask bit set (every chunk of the first 64 of a window is
    tested; values not checked, only the time). Each kernel's real-mask
    call is first held against its plain version on its first
    FLOOR_CHECK images."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
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
    n_ops = _live_pairs(win, fcfg) * PAIR_FLOPS
    for name, (kernel, plain, _, reads_records) in _raster_kernels().items():
        got = kernel(win, rec, **kw)
        torch.cuda.synchronize()
        err = _hold(name, tuple(t[:FLOOR_CHECK] for t in got),
                    plain(sub, sub_rec, **kw),
                    f"floor, first {FLOOR_CHECK} images")
        reads = (win.setup, win.blo, win.bn, win.cmask) + (
            (rec,) if reads_records else ())
        bound_ms, bound_by = _bound(_nbytes(*reads, *got), n_ops,
                                    f"floor {name} (real masks)")
        del got
        t_real = _time_ms(lambda: kernel(win, rec, **kw), reps=8)
        t_ones = _time_ms(lambda: kernel(ones, rec, **kw), reps=8)
        print(f"floor {name}: batch {FLOOR_BATCH} tile_h {fcfg.tile_h} "
              f"{fcfg.raster_cols} cols frontal, real masks {t_real:.4f} ms "
              f"({live} tested chunks; first {FLOOR_CHECK} images equal to "
              f"the plain version, max|err| {err:.3g}), saturated "
              f"{t_ones:.4f} ms (+{added} chunks): "
              f"{(t_ones - t_real) * 1e6 / added:.3f} ns per chunk added; "
              f"real-mask bound {bound_ms:.4f} ms by {bound_by}")
    del bfm, rec, win, ones, sub, sub_rec
    torch.cuda.empty_cache()


def check_ctz_walk():
    """K6 against its plain version at the probe's shape, exactly equal
    for each live-bit count; then the timed probe run (the counters
    reset just before and read just after). Returns the kernel line's
    numbers (at WALK_REPORTED live bits) and the launch counts."""
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.ops import probes
    rng = np.random.default_rng(0)
    setup = torch.as_tensor(rng.standard_normal(probes.SETUP_SHAPE),
                            dtype=torch.float32, device=DEVICE)
    masks = {}
    for live in WALK_LIVE:
        bits = np.zeros(WALK_PROGS, np.int64)
        for r in range(WALK_PROGS):
            idx = rng.choice(32, size=live, replace=False)
            bits[r] = int(np.sum(1 << idx.astype(np.int64)))
        masks[live] = torch.as_tensor(bits.astype(np.uint32).view(np.int32),
                                      device=DEVICE)
    for live, mask in masks.items():
        got = probes.ctz_walk(mask, setup)
        torch.cuda.synchronize()
        ref = probes.ctz_walk_reference(mask, setup)
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"ctz_walk differs from the plain version "
                                 f"at {bad} values ({live} live bits)")

    # the probe's run: counts from 0
    _build.reset_launches()
    times = {live: _time_ms(lambda: probes.ctz_walk(mask, setup), reps=20)
             for live, mask in masks.items()}
    launches = dict(_build.LAUNCHES)
    for live, ms in times.items():
        print(f"ctz_walk: {WALK_PROGS} programs x {live} live bits "
              f"{ms:.4f} ms, {ms * 1e6 / (WALK_PROGS * live):.3f} ns per "
              f"live chunk (equal to the plain version)")
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
    n_tests = WALK_PROGS * WALK_REPORTED * probes.CHUNK * probes.COL_PX
    bound_ms, bound_by = _bound(_nbytes(mask, setup, out),
                                n_tests * WALK_FLOPS, "ctz_walk")
    return dict(ms=times[WALK_REPORTED], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                max_abs_err=0.0), launches


def check_end_to_end(cfg, assets, rng):
    """The inference main path: a checked small batch, a CPU float32
    comparison, then the timed run. Returns its launch counts."""
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
    print(f"inference main path: {n_calls} reconstruct calls, launches "
          f"{launches}")
    if launches != dict(launches, raster_shade=n_calls, raster_select=0,
                        select_grad=0, raster_pos=0, ctz_walk=0):
        raise AssertionError("the inference main path did not launch "
                             "raster_shade once per call (and nothing "
                             "else)")
    del pipe
    torch.cuda.empty_cache()
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


def check_training(cfg, assets):
    """The training main path: a stage split, then 1 warm-up and REPS
    timed steps at batch TRAIN_BATCH with the launch counters reset just
    before and read just after; then the loss-decrease check. Returns
    the main path's launch counts."""
    from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
    from facerecon_tpu_torch.ops import _build
    from facerecon_tpu_torch.pipeline import make_train_pipeline
    from facerecon_tpu_torch.train import init_state, make_train_step
    s = cfg.image_size
    pipe = make_train_pipeline(cfg, assets, device=DEVICE)
    state = init_state(pipe, total_steps=1000, seed=0)
    step = make_train_step(pipe)
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.random((TRAIN_BATCH, s, s, 3)),
                             dtype=torch.float32, device=DEVICE)
    lmk = torch.as_tensor(rng.random((TRAIN_BATCH, 68, 2)) * s,
                          dtype=torch.float32, device=DEVICE)
    _train_stage_split(pipe, state, images, lmk)

    params = list(pipe.model.parameters())
    finite = []

    def checked_step():
        before = dict(_build.LAUNCHES)
        parts = step(state, images, lmk)
        # one flag a step, kept on the device and read after the timed
        # window, so the check adds no host sync to a step
        finite.append(torch.stack(
            [torch.isfinite(p.grad).all() for p in params]
            + [torch.isfinite(parts["total"])]).all())
        new = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        if new != {"raster_shade": 0, "raster_select": 1, "select_grad": 1,
                   "raster_pos": 0, "ctz_walk": 0}:
            raise AssertionError(f"a training step launched {new}")
        return parts

    # the main path: counts from 0, one warm-up step, REPS timed steps
    _build.reset_launches()
    parts = checked_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        parts = checked_step()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / REPS
    launches = dict(_build.LAUNCHES)
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite training loss or gradient")
    print(f"train: {TRAIN_BATCH / dt:.1f} faces/s (batch {TRAIN_BATCH}, bf16 "
          f"BN ResNet-50, {s} px, fwd+bwd+Adam, {dt * 1e3:.1f} ms/step, "
          f"{REPS} steps) on {_card_line()}")
    print(f"training main path: {REPS + 1} steps, launches {launches}, last "
          f"loss {float(parts['total']):.5f}")

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
    del pipe, state
    torch.cuda.empty_cache()
    return launches


def _train_stage_split(pipe, state, images, lmk):
    """ms of each stage of one training step, timed with CUDA events; the
    backward's stages are split by gradient hooks on the select output,
    the records and the coefficients."""
    from facerecon_tpu_torch.ops import rasterize as R
    from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry
    from facerecon_tpu_torch.ops.losses import total_loss
    from facerecon_tpu_torch.ops.render import (RenderOut, _render_fields,
                                                _shade_from_sel, _stack24)
    from facerecon_tpu_torch.ops.sh import illuminate
    from facerecon_tpu_torch.train import make_train_step
    from facerecon_tpu_torch.utils.coeffs import split_coeff
    cfg, bfm, s = pipe.cfg, pipe.bfm, pipe.cfg.image_size
    make_train_step(pipe)(state, images, lmk)           # warm-up
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    state.optimizer.zero_grad(set_to_none=True)
    mark("start")
    coeff_vec = pipe.model(images)
    mark("cnn fwd")
    c = split_coeff(coeff_vec, cfg)
    geom = coeffs_to_geometry(c, bfm, cfg)
    radiance = illuminate(geom.texture, geom.normals, c.gamma)
    mark("geometry+sh fwd")
    rows = bfm.raster_rows
    records = _stack24(_render_fields(geom.verts_ndc, radiance, rows, s, s,
                                      corner_adj=bfm.raster_corner_adj),
                       R.padded_rows(rows.shape[0]), skin=bfm.raster_skin)
    mark("records fwd")
    with torch.no_grad():
        win = R.band_windows(geom.verts_ndc, rows, bfm.raster_row_id, s, s,
                             cfg.tile_h, cfg.raster_cols)
    mark("binning")
    tri_id, _, sel = R.RasterizeSelect.apply(records, win, s, s, cfg.tile_h,
                                             cfg.raster_cols,
                                             bfm.faces.shape[0])
    mark("raster_select (K2)")
    color, bary, skin = _shade_from_sel(tri_id, sel, s, s)
    mask = (tri_id >= 0).to(torch.float32)
    image = color * mask[..., None] + images * (1.0 - mask[..., None])
    out = RenderOut(image=image, mask=mask, tri_id=tri_id, bary=bary,
                    radiance=radiance, geometry=geom, skin=skin)
    total, _ = total_loss(out, c, images, lmk, bfm, cfg)
    mark("shading+losses fwd")
    sel.register_hook(lambda g: mark("shading+losses bwd"))
    records.register_hook(lambda g: mark("select_grad (K3)"))
    coeff_vec.register_hook(lambda g: mark("records+geometry bwd"))
    total.backward()
    mark("cnn bwd")
    state.optimizer.step()
    state.scheduler.step()
    mark("adam")
    torch.cuda.synchronize()
    parts = [f"{n} {a.elapsed_time(b):.3f}"
             for (_, a), (n, b) in zip(marks[:-1], marks[1:])]
    total_ms = marks[0][1].elapsed_time(marks[-1][1])
    print(f"train stage ms (batch {images.shape[0]}): " + ", ".join(parts)
          + f"; total {total_ms:.3f}")


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
    measured = {"raster_shade": _check_raster("raster_shade", MICRO, cfg,
                                              assets, rng)[0]}
    measured["raster_select"], main_select = _check_raster(
        "raster_select", TRAIN_BATCH, cfg, assets, rng)
    measured["select_grad"] = check_select_grad(cfg, main_select)
    del main_select
    torch.cuda.empty_cache()
    measured["raster_pos"] = _check_raster("raster_pos", MICRO, cfg, assets,
                                           rng)[0]
    launches = check_end_to_end(cfg, assets, rng)
    train_launches = check_training(cfg, assets)
    contract_launches = check_contract(cfg, assets)
    check_evaluate()
    check_floor(cfg, assets)
    measured["ctz_walk"], walk_launches = check_ctz_walk()
    launches.update(raster_select=train_launches["raster_select"],
                    select_grad=train_launches["select_grad"],
                    raster_pos=contract_launches["raster_pos"],
                    ctz_walk=walk_launches["ctz_walk"])

    # what each kernel replaces: the Pallas kernel body, file:line
    replaces = {
        "raster_shade": "facerecon_tpu/ops/rasterize_pallas.py:133",
        "raster_select": "facerecon_tpu/ops/rasterize_pallas.py:133",
        "select_grad": "facerecon_tpu/ops/rasterize_pallas.py:1109",
        "raster_pos": "facerecon_tpu/ops/rasterize_pallas.py:133",
        "ctz_walk": "benchmarks/ctzloop_probe.py:48"}
    kernels = [dict(
        name=name, route="cuda",
        source=f"facerecon_tpu_torch/csrc/{name}.cu",
        replaces=replaces[name], launches=launches[name],
        max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
        bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=m.get("library_ms")) for name, m in measured.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
