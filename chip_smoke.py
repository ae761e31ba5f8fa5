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
     deterministic). Times each kernel and its plain version.
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
  6. prints the per-kernel JSON line, the card line, and as the last line
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


def _check_raster(name, main_batch, cfg, assets, rng, kernel, plain,
                  compare):
    """A rasterizer kernel against its plain version on both row orders.
    Returns the kernel line's numbers at the main path's shapes and the
    (windows, records, outputs) of the asset-order batch."""
    from facerecon_tpu_torch.data.synthetic import sample_coeffs
    from facerecon_tpu_torch.ops.geometry import device_bfm
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
        if not torch.equal(got[0], ref[0]):
            bad = int((got[0] != ref[0]).sum())
            raise AssertionError(f"{name} tri_id differs from the plain "
                                 f"version at {bad} pixels ({order})")
        err = compare(got, ref, order)
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
            bound_ms, bound_by = _bound(
                _nbytes(win.setup, rec, win.blo, win.bn, win.cmask, *got),
                pairs * PAIR_FLOPS, name)
            result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
            main = (win, rec, got)
        else:
            del rec, win, got, ref
    del bfm
    torch.cuda.empty_cache()
    return dict(result, max_abs_err=max_err), main


def check_raster_shade(cfg, assets, rng):
    """K1 against its plain version, both row orders: tri_id exact,
    color and bary within 1e-6."""
    from facerecon_tpu_torch.ops import rasterize as R

    def compare(got, ref, order):
        err = max(float((a - b).abs().max()) for a, b in zip(got[1:],
                                                             ref[1:]))
        if not err <= 1e-6:
            raise AssertionError(f"raster_shade color/bary differ by {err} "
                                 f"({order})")
        return err

    measured, _ = _check_raster("raster_shade", MICRO, cfg, assets, rng,
                                R.shade_windows, R.shade_windows_reference,
                                compare)
    return measured


def check_raster_select(cfg, assets, rng):
    """K2 against its plain version, both row orders: tri_id, row and sel
    exactly equal (sel is a copy of record values). Returns the kernel
    line's numbers and the asset-order batch's windows and outputs."""
    from facerecon_tpu_torch.ops import rasterize as R

    def compare(got, ref, order):
        for k, what in ((1, "row"), (2, "sel")):
            if not torch.equal(got[k], ref[k]):
                bad = int((got[k] != ref[k]).sum())
                raise AssertionError(f"raster_select {what} differs from "
                                     f"the plain version at {bad} "
                                     f"elements ({order})")
        return float((got[2] - ref[2]).abs().max())

    return _check_raster("raster_select", TRAIN_BATCH, cfg, assets, rng,
                         R.select_windows, R.select_windows_reference,
                         compare)


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
                        select_grad=0):
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
        if new != {"raster_shade": 0, "raster_select": 1, "select_grad": 1}:
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
    measured = {"raster_shade": check_raster_shade(cfg, assets, rng)}
    measured["raster_select"], main_select = check_raster_select(
        cfg, assets, rng)
    measured["select_grad"] = check_select_grad(cfg, main_select)
    del main_select
    torch.cuda.empty_cache()
    launches = check_end_to_end(cfg, assets, rng)
    train_launches = check_training(cfg, assets)
    launches.update(raster_select=train_launches["raster_select"],
                    select_grad=train_launches["select_grad"])

    # what each kernel replaces: the Pallas kernel body, file:line
    replaces = {
        "raster_shade": "facerecon_tpu/ops/rasterize_pallas.py:133",
        "raster_select": "facerecon_tpu/ops/rasterize_pallas.py:133",
        "select_grad": "facerecon_tpu/ops/rasterize_pallas.py:1109"}
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
