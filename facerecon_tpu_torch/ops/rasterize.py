"""Fused z-buffer rasterizers (twin of facerecon_tpu/ops/rasterize_pallas.py).

Setup and records follow the asset's static RASTER ROW ORDER (faces sorted
by mean-shape (y-bin, x), each bin padded to a 128-row chunk), so every
band of `tile_h` pixel rows finds its candidates in one contiguous window
of chunks, and every column tile of the band in the chunks whose bit is
set in its exact chunk mask (ops/binning.py). The z-test compares
(depth, original face id) lexicographically, so the lowest-face-id tie
rule holds under any row order.

`band_windows` builds the kernels' inputs. Four kernels, each with a
wrapper that launches it on CUDA tensors, runs its plain PyTorch version
(`*_reference`, the same function) on CPU tensors, and counts launches in
`_build.LAUNCHES`:
  - `shade_windows` -> `csrc/raster_shade.cu` (K1, inference: z-test +
    in-kernel shading); `rasterize_shaded` chains binning and K1;
  - `select_windows` -> `csrc/raster_select.cu` (K2, training forward:
    z-test + the winner's record fields and raster row);
  - `select_grad` -> `csrc/select_grad.cu` (K3, K2's adjoint: per raster
    row, the sum of its pixels' cotangent);
  - `pos_windows` -> `csrc/raster_pos.cu` (K4, the z-test alone: winner
    face id, depth and raster row).
`RasterizeSelect` is the autograd Function over K2 and K3, and
`rasterize_select` chains binning and it. `rasterize_positions` chains
binning and K4, and `rasterize_batch` (the §9.5 (tri_id, bary, zbuf)
contract) decodes K4's winners.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops.binning import bin_triangles_static_t

_CHUNK = 128            # triangles per chunk (window-granularity unit)
_WINDOW = 64            # chunks covered by the column masks
_MWORDS = 2             # int32 chunk-mask words per (band, col)
_BGRP = 8               # row-count rounding shared with the reference
_ROW_PAD = 16           # setup record fields padded 12 -> 16
_FIELDS = 24            # render-attribute record width
_REF_ROWS = 8192        # rows per step of the plain version's window walk
_SEL = 20               # record fields the select returns per pixel
_GRAD = 17              # differentiable record fields


def padded_rows(n_faces: int) -> int:
    """Static row count of the padded setup/record arrays for n_faces:
    whole chunks plus a full mask window of slack, rounded to 8 chunks
    (the same count as the reference, so records carry over as they
    are)."""
    chunks = (n_faces + _CHUNK - 1) // _CHUNK + _WINDOW
    chunks = (chunks + _BGRP - 1) // _BGRP * _BGRP
    return chunks * _CHUNK


def col_width(width: int, n_cols: int) -> int:
    """Per-column pixel width: ceil(width / n_cols) rounded up to 8; the
    padded band is n_cols * col_width wide."""
    return ((width + n_cols - 1) // n_cols + 7) // 8 * 8


class Windows(NamedTuple):
    blo: torch.Tensor    # (B, n_bands) int32 band union window first chunk
    bn: torch.Tensor     # (B, n_bands) int32 band union window chunk count
    cmask: torch.Tensor  # (B, n_bands * n_cols * 2) int32 column masks
    setup: torch.Tensor  # (B, 16, rows) f32 setup, field 12 = face id


def band_windows(verts_ndc, row_faces, row_id, height: int, width: int,
                 tile_h: int, n_cols: int,
                 cull_backfaces: bool = False) -> Windows:
    """Static binning over the raster row order (twin of the reference's
    _band_windows): per-band union windows, per-(band, column) exact
    chunk masks, and the padded field-major setup whose field 12 carries
    the ORIGINAL face id. Slack rows get wc0 = wc1 = -3e38, so they never
    cover a pixel."""
    bsz = verts_ndc.shape[0]
    st = bin_triangles_static_t(verts_ndc, row_faces, height, width,
                                tile_h, _CHUNK, cull_backfaces,
                                tile_w=col_width(width, n_cols),
                                mask_words=_MWORDS)
    f = st.coeffs_t[0].shape[1]
    rows = padded_rows(f)
    setup = verts_ndc.new_zeros((bsz, _ROW_PAD, rows))
    setup[:, :12, :f] = torch.stack(st.coeffs_t, dim=1)
    setup[:, 12, :f] = row_id.to(torch.float32)
    setup[:, 2:6:3, f:] = -3e38
    return Windows(blo=st.band_lo, bn=st.n_chunks,
                   cmask=st.chunk_mask.reshape(bsz, -1), setup=setup)


def _check_inputs(win: Windows, records, height, width, tile_h, n_cols):
    """Check the windows (and the records, where the kernel takes them)
    against the kernel's layout, all on the setup's device."""
    bsz, _, rows = win.setup.shape
    n_bands = (height + tile_h - 1) // tile_h
    want = {
        "setup": (win.setup, torch.float32, (bsz, _ROW_PAD, rows)),
        "blo": (win.blo, torch.int32, (bsz, n_bands)),
        "bn": (win.bn, torch.int32, (bsz, n_bands)),
        "cmask": (win.cmask, torch.int32, (bsz, n_bands * n_cols * _MWORDS)),
    }
    if records is not None:
        want["records"] = (records, torch.float32, (bsz, _FIELDS, rows))
    _build.check_tensors(win.setup.device, want)


def _raster_ints(win: Windows, height, width, tile_h, n_cols, n_faces):
    """The raster kernels' int arguments, after the block-size check: the
    kernels run one thread a pixel of a band's column tile, so a tile of
    more than 1024 pixels is refused here, on the launch path only (the
    plain versions take any band)."""
    col_w = col_width(width, n_cols)
    if tile_h * col_w > 1024:
        raise ValueError(f"tile_h * col_width = {tile_h * col_w} pixels "
                         "exceeds one block of 1024 threads")
    bsz, _, rows = win.setup.shape
    return (bsz, height, width, tile_h, n_cols, col_w,
            (height + tile_h - 1) // tile_h, rows, n_faces)


def shade_windows(win: Windows, records, *, height: int, width: int,
                  tile_h: int, n_cols: int, n_faces: int):
    """Rasterize + shade from prepared windows: K1's wrapper.

    records (B, 24, rows) f32 render attributes in raster row order
    (render.pack_render_records). Returns (tri_id (B,H,W) int32 original
    face ids, -1 = background; color (B,H,W,3) f32; bary (B,H,W,3) f32).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check_inputs(win, records, height, width, tile_h, n_cols)
    if not _build.on_card(records.device):
        return shade_windows_reference(win, records, height=height,
                                       width=width, tile_h=tile_h,
                                       n_cols=n_cols, n_faces=n_faces)
    bsz, dev = records.shape[0], records.device
    tri_id = torch.empty((bsz, height, width), dtype=torch.int32, device=dev)
    color = torch.empty((bsz, height, width, 3), dtype=torch.float32,
                        device=dev)
    bary = torch.empty_like(color)
    ints = _raster_ints(win, height, width, tile_h, n_cols, n_faces)
    if bsz:
        _build.launch("raster_shade", dev, (win.setup, records, win.blo,
                                            win.bn, win.cmask, tri_id, color,
                                            bary), ints)
    return tri_id, color, bary


def select_windows(win: Windows, records, *, height: int, width: int,
                   tile_h: int, n_cols: int, n_faces: int):
    """Rasterize + select the winner's record from prepared windows: K2's
    wrapper.

    records (B, 24, rows) f32 in raster row order (render._stack24).
    Returns (tri_id (B,H,W) int32 original face ids and row (B,H,W)
    int32 winner raster rows, both -1 on background; sel (B,20,H,W) f32,
    fields 0..19 of the winner's record, zero on background). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _check_inputs(win, records, height, width, tile_h, n_cols)
    if not _build.on_card(records.device):
        return select_windows_reference(win, records, height=height,
                                        width=width, tile_h=tile_h,
                                        n_cols=n_cols, n_faces=n_faces)
    bsz, dev = records.shape[0], records.device
    tri_id = torch.empty((bsz, height, width), dtype=torch.int32, device=dev)
    row = torch.empty_like(tri_id)
    sel = torch.empty((bsz, _SEL, height, width), dtype=torch.float32,
                      device=dev)
    ints = _raster_ints(win, height, width, tile_h, n_cols, n_faces)
    if bsz:
        _build.launch("raster_select", dev, (win.setup, records, win.blo,
                                             win.bn, win.cmask, tri_id, row,
                                             sel), ints)
    return tri_id, row, sel


def pos_windows(win: Windows, *, height: int, width: int, tile_h: int,
                n_cols: int, n_faces: int):
    """The z-test alone from prepared windows: K4's wrapper.

    Returns (tri_id (B,H,W) int32 original face ids, -1 = background;
    zbuf (B,H,W) f32 the winner's depth, +inf on background; row (B,H,W)
    int32 the winner's raster row, -1 on background). CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    _check_inputs(win, None, height, width, tile_h, n_cols)
    dev = win.setup.device
    if not _build.on_card(dev):
        return pos_windows_reference(win, height=height, width=width,
                                     tile_h=tile_h, n_cols=n_cols,
                                     n_faces=n_faces)
    bsz = win.setup.shape[0]
    tri_id = torch.empty((bsz, height, width), dtype=torch.int32, device=dev)
    zbuf = torch.empty((bsz, height, width), dtype=torch.float32, device=dev)
    row = torch.empty_like(tri_id)
    ints = _raster_ints(win, height, width, tile_h, n_cols, n_faces)
    if bsz:
        _build.launch("raster_pos", dev, (win.setup, win.blo, win.bn,
                                          win.cmask, tri_id, zbuf, row), ints)
    return tri_id, zbuf, row


def _band_winners(win: Windows, height: int, width: int, tile_h: int,
                  n_cols: int, n_faces: int):
    """The plain z-test shared by the kernels' plain versions. Yields
    (b, t, hit, ids, best_row, best_z, px, py) for every band with a
    window: per pixel of the padded band (row-major), whether a face
    covers it, the winner's original face id, raster row and depth, and
    the pixel center.

    Walks each band's whole union window [blo, blo + bn) in row blocks,
    without the column masks: they prune only chunks that cover none of
    the column's pixels, so the winner is the same. Every float op is the
    kernels' (raster_common.cuh), in their order."""
    setup = win.setup
    bsz = setup.shape[0]
    dev = setup.device
    tile_w = col_width(width, n_cols) * n_cols
    n_bands = (height + tile_h - 1) // tile_h
    band_px = tile_h * tile_w
    pix = torch.arange(band_px, device=dev)
    px = (pix % tile_w).to(torch.float32) + 0.5
    ty = (pix // tile_w).to(torch.float32)
    blo = win.blo.tolist()
    bn = win.bn.tolist()
    inf = torch.tensor(float("inf"), device=dev)
    for b in range(bsz):
        for t in range(n_bands):
            if bn[b][t] == 0:
                continue
            py = ty + float(t * tile_h) + 0.5
            best_z = torch.full((band_px,), float("inf"), device=dev)
            best_id = torch.full((band_px,), 3e38, device=dev)
            best_row = torch.zeros((band_px,), dtype=torch.int64, device=dev)
            lo, hi = blo[b][t] * _CHUNK, (blo[b][t] + bn[b][t]) * _CHUNK
            for r0 in range(lo, hi, _REF_ROWS):
                cf = setup[b, :, r0:min(r0 + _REF_ROWS, hi)]
                qx = px[:, None] - cf[9]
                qy = py[:, None] - cf[10]
                e0 = cf[0] * qx + cf[1] * qy + cf[2]
                e1 = cf[3] * qx + cf[4] * qy + cf[5]
                ez = cf[6] * qx + cf[7] * qy + cf[8]
                cov = (e0 >= 0.0) & (e1 >= 0.0) & (e0 + e1 <= 1.0)
                zm = torch.where(cov, ez, inf)
                zmin = zm.amin(dim=1)
                at_min = cov & (zm == zmin[:, None])
                idw = torch.where(at_min, cf[12], 3e38).amin(dim=1)
                row = r0 + torch.argmax(
                    (at_min & (cf[12] == idw[:, None])).to(torch.uint8),
                    dim=1)
                better = (zmin < best_z) | ((zmin == best_z)
                                            & (idw < best_id))
                best_z = torch.where(better, zmin, best_z)
                best_id = torch.where(better, idw, best_id)
                best_row = torch.where(better, row, best_row)
            ids = best_id.to(torch.int64)
            hit = (best_z < 3e37) & (ids >= 0) & (ids < n_faces)
            yield b, t, hit, ids, best_row, best_z, px, py


def _unband(a, height: int, width: int, tile_h: int):
    """(B, n_bands, band_px, ...) banded row-major pixels -> (B, H, W, ...)
    cropped to the image."""
    bsz, n_bands, band_px = a.shape[:3]
    a = a.reshape(bsz, n_bands * tile_h, band_px // tile_h, *a.shape[3:])
    return a[:, :height, :width].contiguous()


def shade_windows_reference(win: Windows, records, *, height: int,
                            width: int, tile_h: int, n_cols: int,
                            n_faces: int):
    """Plain PyTorch version of K1, on the same inputs: the plain z-test
    (_band_winners), then the winner's barycentrics and blended radiance
    with the kernel's float ops in its order."""
    bsz = win.setup.shape[0]
    dev = win.setup.device
    n_bands = (height + tile_h - 1) // tile_h
    band_px = tile_h * col_width(width, n_cols) * n_cols
    tri = torch.full((bsz, n_bands, band_px), -1, dtype=torch.int32,
                     device=dev)
    color = torch.zeros((bsz, n_bands, band_px, 3), device=dev)
    bary = torch.zeros_like(color)
    for b, t, hit, ids, best_row, _, px, py in _band_winners(
            win, height, width, tile_h, n_cols, n_faces):
        rec = records[b, :17, best_row]                # (17, band_px)
        qx = px - rec[15]
        qy = py - rec[16]
        w0 = rec[9] * qx + rec[10] * qy + rec[11]
        w1 = rec[12] * qx + rec[13] * qy + rec[14]
        w2 = 1.0 - w0 - w1
        rgb = torch.stack([w0 * rec[c] + w1 * rec[c + 3]
                           + w2 * rec[c + 6] for c in range(3)], -1)
        hit3 = hit[:, None]
        tri[b, t] = torch.where(hit, ids, -1).to(torch.int32)
        color[b, t] = torch.where(hit3, rgb, 0.0)
        bary[b, t] = torch.where(hit3, torch.stack([w0, w1, w2], -1), 0.0)
    return tuple(_unband(a, height, width, tile_h)
                 for a in (tri, color, bary))


def select_windows_reference(win: Windows, records, *, height: int,
                             width: int, tile_h: int, n_cols: int,
                             n_faces: int):
    """Plain PyTorch version of K2, on the same inputs: the plain z-test
    (_band_winners), then a copy of the winner's fields 0..19."""
    bsz = win.setup.shape[0]
    dev = win.setup.device
    n_bands = (height + tile_h - 1) // tile_h
    band_px = tile_h * col_width(width, n_cols) * n_cols
    tri = torch.full((bsz, n_bands, band_px), -1, dtype=torch.int32,
                     device=dev)
    row = torch.full_like(tri, -1)
    sel = torch.zeros((bsz, n_bands, band_px, _SEL), device=dev)
    for b, t, hit, ids, best_row, _, _, _ in _band_winners(
            win, height, width, tile_h, n_cols, n_faces):
        tri[b, t] = torch.where(hit, ids, -1).to(torch.int32)
        row[b, t] = torch.where(hit, best_row, -1).to(torch.int32)
        sel[b, t] = torch.where(hit[:, None], records[b, :_SEL, best_row].T,
                                0.0)
    tri, row, sel = (_unband(a, height, width, tile_h)
                     for a in (tri, row, sel))
    return tri, row, sel.permute(0, 3, 1, 2).contiguous()


def pos_windows_reference(win: Windows, *, height: int, width: int,
                          tile_h: int, n_cols: int, n_faces: int):
    """Plain PyTorch version of K4, on the same inputs: the plain z-test
    (_band_winners), then the winner's id, depth and raster row."""
    bsz = win.setup.shape[0]
    dev = win.setup.device
    n_bands = (height + tile_h - 1) // tile_h
    band_px = tile_h * col_width(width, n_cols) * n_cols
    tri = torch.full((bsz, n_bands, band_px), -1, dtype=torch.int32,
                     device=dev)
    row = torch.full_like(tri, -1)
    zbuf = torch.full((bsz, n_bands, band_px), float("inf"), device=dev)
    for b, t, hit, ids, best_row, best_z, _, _ in _band_winners(
            win, height, width, tile_h, n_cols, n_faces):
        tri[b, t] = torch.where(hit, ids, -1).to(torch.int32)
        zbuf[b, t] = torch.where(hit, best_z, float("inf"))
        row[b, t] = torch.where(hit, best_row, -1).to(torch.int32)
    return tuple(_unband(a, height, width, tile_h) for a in (tri, zbuf, row))


def _check_grad_inputs(row, g, blo, bn, rows: int, tile_h: int):
    bsz, height, width = row.shape
    n_bands = (height + tile_h - 1) // tile_h
    if rows % _CHUNK:
        raise ValueError(f"rows = {rows} is not a multiple of {_CHUNK}")
    _build.check_tensors(g.device, {
        "row": (row, torch.int32, (bsz, height, width)),
        "g": (g, torch.float32, (bsz, _SEL, height, width)),
        "blo": (blo, torch.int32, (bsz, n_bands)),
        "bn": (bn, torch.int32, (bsz, n_bands)),
    })


def select_grad(row, g, blo, bn, *, rows: int, tile_h: int):
    """The adjoint of the select: K3's wrapper.

    row (B,H,W) int32 winner raster rows (-1 = background), g (B,20,H,W)
    f32 cotangent of the select's fields, blo/bn the forward's band
    windows. Returns d_rec (B, 24, rows) f32: per raster row, the sum of
    its pixels' cotangent for fields 0..16, zero for fields 17..23.
    Deterministic on the card (no float atomics). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check_grad_inputs(row, g, blo, bn, rows, tile_h)
    if not _build.on_card(g.device):
        return select_grad_reference(row, g, blo, bn, rows=rows,
                                     tile_h=tile_h)
    bsz, height, width = row.shape
    d_rec = torch.empty((bsz, _FIELDS, rows), dtype=torch.float32,
                        device=g.device)
    if bsz:
        _build.launch("select_grad", g.device, (row, g, blo, bn, d_rec),
                (bsz, height, width, tile_h, blo.shape[1], rows))
    return d_rec


def select_grad_reference(row, g, blo, bn, *, rows: int, tile_h: int):
    """Plain PyTorch version of K3: one index_add_ of the covered pixels'
    cotangent rows, in pixel order. It needs no band windows (they only
    prune the kernel's walk), so `blo`, `bn` and `tile_h` go unused."""
    del blo, bn, tile_h
    bsz = row.shape[0]
    hit = row >= 0
    src = g[:, :_GRAD].permute(0, 2, 3, 1)[hit]              # (n, 17)
    dst = (row.to(torch.int64)
           + torch.arange(bsz, device=row.device)[:, None, None] * rows)[hit]
    acc = g.new_zeros((bsz * rows, _GRAD)).index_add_(0, dst, src)
    d_rec = g.new_zeros((bsz, _FIELDS, rows))
    d_rec[:, :_GRAD] = acc.reshape(bsz, rows, _GRAD).transpose(1, 2)
    return d_rec


class RasterizeSelect(torch.autograd.Function):
    """Differentiable raster + select (twin of the reference's _rs_core
    custom VJP): differentiable in `records` only. The forward is K2
    (select_windows); tri_id and row are integer outputs, marked
    non-differentiable (tri_id frozen, SURVEY §9.6); the backward is K3
    (select_grad) over the saved winner rows and band windows."""

    @staticmethod
    def forward(ctx, records, win: Windows, height: int, width: int,
                tile_h: int, n_cols: int, n_faces: int):
        tri_id, row, sel = select_windows(
            win, records, height=height, width=width, tile_h=tile_h,
            n_cols=n_cols, n_faces=n_faces)
        ctx.save_for_backward(row, win.blo, win.bn)
        ctx.mark_non_differentiable(tri_id, row)
        ctx.rows, ctx.tile_h = records.shape[2], tile_h
        return tri_id, row, sel

    @staticmethod
    def backward(ctx, _g_tri, _g_row, g_sel):
        row, blo, bn = ctx.saved_tensors
        d_rec = select_grad(row, g_sel.contiguous(), blo, bn,
                            rows=ctx.rows, tile_h=ctx.tile_h)
        return d_rec, None, None, None, None, None, None


def _row_order(faces, row_faces, row_id):
    """The static raster row order, or the identity order when None."""
    if row_faces is None:
        return faces, torch.arange(faces.shape[0], device=faces.device)
    return row_faces, row_id


def _rasterize(core, records, verts_ndc, faces, height, width, tile_h,
               n_cols, row_faces, row_id):
    row_faces, row_id = _row_order(faces, row_faces, row_id)
    with torch.no_grad():
        win = band_windows(verts_ndc, row_faces, row_id, height, width,
                           tile_h, n_cols)
        return core(win, records.contiguous(), height=height, width=width,
                    tile_h=tile_h, n_cols=n_cols, n_faces=faces.shape[0])


def rasterize_shaded(records, verts_ndc, faces, *, height: int, width: int,
                     tile_h: int, n_cols: int = 1, row_faces=None,
                     row_id=None):
    """Fused raster + in-kernel shading, the inference hot path.

    records (B, 24, padded_rows(F')) f32 in raster row order; verts_ndc
    (B, N, 3); faces (F, 3); row_faces/row_id the static raster row order
    (identity when None). Returns (tri_id (B,H,W) int32, color (B,H,W,3)
    f32, bary (B,H,W,3) f32). Runs on the device of its inputs; no
    gradients."""
    return _rasterize(shade_windows, records, verts_ndc, faces, height,
                      width, tile_h, n_cols, row_faces, row_id)


def rasterize_shaded_reference(records, verts_ndc, faces, *, height: int,
                               width: int, tile_h: int, n_cols: int = 1,
                               row_faces=None, row_id=None):
    """rasterize_shaded through the plain version on any device."""
    return _rasterize(shade_windows_reference, records, verts_ndc, faces,
                      height, width, tile_h, n_cols, row_faces, row_id)


def rasterize_select(records, verts_ndc, faces, *, height: int, width: int,
                     tile_h: int, n_cols: int = 1, row_faces=None,
                     row_id=None):
    """Fused raster + winner-record select, the training render's hot
    path (twin of the reference's rasterize_select).

    records (B, 24, padded_rows(F')) f32 in raster row order; verts_ndc
    (B, N, 3); faces (F, 3); row_faces/row_id the static raster row order
    (identity when None). Returns (tri_id (B,H,W) int32, row (B,H,W)
    int32, sel (B,20,H,W) f32). Differentiable in `records` only:
    `verts_ndc` is detached (the binning and the z-test carry no
    gradient) and tri_id is frozen."""
    row_faces, row_id = _row_order(faces, row_faces, row_id)
    with torch.no_grad():
        win = band_windows(verts_ndc.detach(), row_faces, row_id, height,
                           width, tile_h, n_cols)
    return RasterizeSelect.apply(records.contiguous(), win, height, width,
                                 tile_h, n_cols, faces.shape[0])


def _positions(verts_ndc, faces, height, width, tile_h, n_cols,
               cull_backfaces, row_faces, row_id):
    """Binning over the row order (identity when None), then K4: the
    windows and K4's (tri_id, zbuf, row)."""
    row_faces, row_id = _row_order(faces, row_faces, row_id)
    win = band_windows(verts_ndc, row_faces, row_id, height, width, tile_h,
                       n_cols, cull_backfaces)
    return (win, *pos_windows(win, height=height, width=width,
                              tile_h=tile_h, n_cols=n_cols,
                              n_faces=faces.shape[0]))


@torch.no_grad()
def rasterize_positions(verts_ndc, faces, *, height: int, width: int,
                        tile_h: int = 2, n_cols: int = 1,
                        cull_backfaces: bool = False, row_faces=None,
                        row_id=None):
    """Batched hard-visibility pass (twin of the reference's
    rasterize_positions): binning, then K4.

    verts_ndc (B, N, 3), faces (F, 3); row_faces/row_id the static raster
    row order (identity when None). Returns (tri_id (B,H,W) int32
    winning face index in ORIGINAL face order (-1 = background), setup
    (B, 16, rows) f32 in raster row order, zbuf (B,H,W) f32 (+inf on
    background), (blo, bn) the band union chunk windows). No
    gradients."""
    win, tri_id, zbuf, _ = _positions(verts_ndc, faces, height, width,
                                      tile_h, n_cols, cull_backfaces,
                                      row_faces, row_id)
    return tri_id, win.setup, zbuf, (win.blo, win.bn)


def decode_bary(setup, row, height: int, width: int):
    """Barycentrics (B,H,W,3) of each pixel's winner from its setup row
    (row (B,H,W) int32, -1 = background -> 0): the winner's anchored w
    forms at the pixel center, qx = (j + 0.5) - x0, qy = (i + 0.5) - y0,
    w0 = wa0*qx + wb0*qy + wc0, w1 likewise, w2 = 1 - w0 - w1, in the
    reference decode's float order."""
    bsz = row.shape[0]
    dev = setup.device
    idx = row.clamp(min=0).to(torch.int64).reshape(bsz, 1, -1)
    f = torch.gather(setup[:, :11], 2, idx.expand(bsz, 11, idx.shape[2]))
    f = f.reshape(bsz, 11, height, width)
    px = torch.arange(width, device=dev, dtype=torch.float32) + 0.5
    py = (torch.arange(height, device=dev, dtype=torch.float32)
          + 0.5)[:, None]
    qx = px - f[:, 9]
    qy = py - f[:, 10]
    w0 = f[:, 0] * qx + f[:, 1] * qy + f[:, 2]
    w1 = f[:, 3] * qx + f[:, 4] * qy + f[:, 5]
    hit = row >= 0
    return torch.stack([torch.where(hit, v, 0.0)
                        for v in (w0, w1, 1.0 - w0 - w1)], dim=-1)


@torch.no_grad()
def rasterize_batch(verts_ndc, faces, *, height: int, width: int, cfg=None,
                    tile_h: int = 2, n_cols: int = 1,
                    cull_backfaces: bool = False, row_faces=None,
                    row_id=None):
    """The full SURVEY.md §9.5 contract, batched: (tri_id (B,H,W) int32,
    bary (B,H,W,3) f32, zbuf (B,H,W) f32), zero bary and +inf zbuf on
    background. cfg, when given, sets tile_h. No gradients.

    One K4 launch (pos_windows), then an elementwise decode: zbuf is
    K4's winning depth (za*qx + zb*qy + z0 in the z-test's own order)
    and the barycentrics come from the winner's setup row (decode_bary).
    The reference routes this contract through its select kernel with a
    48-row bf16 contract record (_pack_contract_records, _split3),
    because on the TPU its pos pass relaid each band in-kernel and its
    decode needed a per-pixel row gather that runs at about one element
    a cycle. Neither holds here: a pixel's winner row is a plain gather,
    and K4 writes 12 bytes a pixel against the select's 88. The bf16
    split only carried the f32 fields exactly through the TPU's bf16
    matrix unit, so it is not ported; the values are the same."""
    if cfg is not None:
        tile_h = cfg.tile_h
    win, tri_id, zbuf, row = _positions(verts_ndc, faces, height, width,
                                        tile_h, n_cols, cull_backfaces,
                                        row_faces, row_id)
    return tri_id, decode_bary(win.setup, row, height, width), zbuf


def rasterize(verts_ndc, faces, *, height: int, width: int, tile_h: int = 2,
              cull_backfaces: bool = False):
    """Single-mesh wrapper of rasterize_batch: verts_ndc (N, 3) ->
    (tri_id (H,W), bary (H,W,3), zbuf (H,W))."""
    tri_id, bary, zbuf = rasterize_batch(
        verts_ndc[None], faces, height=height, width=width, tile_h=tile_h,
        cull_backfaces=cull_backfaces)
    return tri_id[0], bary[0], zbuf[0]
