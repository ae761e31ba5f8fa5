"""Fused z-buffer rasterizer + shading (twin of the inference path of
facerecon_tpu/ops/rasterize_pallas.py).

Setup and records follow the asset's static RASTER ROW ORDER (faces sorted
by mean-shape (y-bin, x), each bin padded to a 128-row chunk), so every
band of `tile_h` pixel rows finds its candidates in one contiguous window
of chunks, and every column tile of the band in the chunks whose bit is
set in its exact chunk mask (ops/binning.py). The z-test compares
(depth, original face id) lexicographically, so the lowest-face-id tie
rule holds under any row order.

`band_windows` builds the kernel's inputs. `shade_windows` is the kernel's
wrapper: on CUDA tensors it launches `csrc/raster_shade.cu`, on CPU
tensors it runs `shade_windows_reference`, the plain PyTorch version of
the same function. `rasterize_shaded` chains the two.
"""

from __future__ import annotations

import ctypes
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
                 tile_h: int, n_cols: int) -> Windows:
    """Static binning over the raster row order (twin of the reference's
    _band_windows): per-band union windows, per-(band, column) exact
    chunk masks, and the padded field-major setup whose field 12 carries
    the ORIGINAL face id. Slack rows get wc0 = wc1 = -3e38, so they never
    cover a pixel."""
    bsz = verts_ndc.shape[0]
    st = bin_triangles_static_t(verts_ndc, row_faces, height, width,
                                tile_h, _CHUNK,
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
    bsz, _, rows = win.setup.shape
    n_bands = (height + tile_h - 1) // tile_h
    dev = records.device
    want = {
        "setup": (win.setup, torch.float32, (bsz, _ROW_PAD, rows)),
        "records": (records, torch.float32, (bsz, _FIELDS, rows)),
        "blo": (win.blo, torch.int32, (bsz, n_bands)),
        "bn": (win.bn, torch.int32, (bsz, n_bands)),
        "cmask": (win.cmask, torch.int32, (bsz, n_bands * n_cols * _MWORDS)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, records on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def shade_windows(win: Windows, records, *, height: int, width: int,
                  tile_h: int, n_cols: int, n_faces: int):
    """Rasterize + shade from prepared windows: the kernel's wrapper.

    records (B, 24, rows) f32 render attributes in raster row order
    (render.pack_render_records). Returns (tri_id (B,H,W) int32 original
    face ids, -1 = background; color (B,H,W,3) f32; bary (B,H,W,3) f32).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check_inputs(win, records, height, width, tile_h, n_cols)
    if records.device.type == "cpu":
        return shade_windows_reference(win, records, height=height,
                                       width=width, tile_h=tile_h,
                                       n_cols=n_cols, n_faces=n_faces)
    if records.device.type != "cuda":
        raise ValueError(f"unsupported device {records.device}")
    bsz, _, rows = win.setup.shape
    dev = records.device
    tri_id = torch.empty((bsz, height, width), dtype=torch.int32, device=dev)
    color = torch.empty((bsz, height, width, 3), dtype=torch.float32,
                        device=dev)
    bary = torch.empty_like(color)
    if bsz == 0:
        return tri_id, color, bary
    col_w = col_width(width, n_cols)
    if tile_h * col_w > 1024:
        raise ValueError(f"tile_h * col_width = {tile_h * col_w} pixels "
                         "exceeds one block of 1024 threads")
    fn = _build.load("raster_shade").raster_shade
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(win.setup.data_ptr(), records.data_ptr(),
                 win.blo.data_ptr(), win.bn.data_ptr(), win.cmask.data_ptr(),
                 tri_id.data_ptr(), color.data_ptr(), bary.data_ptr(),
                 bsz, height, width, tile_h, n_cols, col_w,
                 (height + tile_h - 1) // tile_h, rows, n_faces, stream)
    if err != 0:
        raise RuntimeError(f"raster_shade launch failed: CUDA error {err}")
    _build.LAUNCHES["raster_shade"] += 1
    return tri_id, color, bary


def shade_windows_reference(win: Windows, records, *, height: int,
                            width: int, tile_h: int, n_cols: int,
                            n_faces: int):
    """Plain PyTorch version of the kernel, on the same inputs.

    Walks each band's whole union window [blo, blo + bn) in row blocks,
    without the column masks: they prune only chunks that cover none of
    the column's pixels, so the winner is the same. Every float op is the
    kernel's, in the kernel's order."""
    setup = win.setup
    bsz, _, rows = setup.shape
    dev = setup.device
    tile_w = col_width(width, n_cols) * n_cols
    n_bands = (height + tile_h - 1) // tile_h
    band_px = tile_h * tile_w
    pix = torch.arange(band_px, device=dev)
    px = (pix % tile_w).to(torch.float32) + 0.5
    ty = (pix // tile_w).to(torch.float32)
    tri = torch.full((bsz, n_bands, band_px), -1, dtype=torch.int32,
                     device=dev)
    color = torch.zeros((bsz, n_bands, band_px, 3), device=dev)
    bary = torch.zeros_like(color)
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
            bary[b, t] = torch.where(hit3, torch.stack([w0, w1, w2], -1),
                                     0.0)

    def unband(a):
        a = a.reshape(bsz, n_bands * tile_h, tile_w, *a.shape[3:])
        return a[:, :height, :width].contiguous()

    return unband(tri), unband(color), unband(bary)


def _rasterize(core, records, verts_ndc, faces, height, width, tile_h,
               n_cols, row_faces, row_id):
    if row_faces is None:
        row_faces = faces
        row_id = torch.arange(faces.shape[0], device=faces.device)
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
