"""Fused z-buffer rasterizers (twin of facerecon_tpu/ops/rasterize_pallas.py).

Setup and records follow the asset's static RASTER ROW ORDER (faces sorted
by mean-shape (y-bin, x), each bin padded to a 128-row chunk), so every
band of `tile_h` pixel rows finds its candidates in one contiguous window
of chunks, and every column tile of the band in the chunks whose bit is
set in its exact chunk mask (ops/binning.py). The z-test compares
(depth, original face id) lexicographically, so the lowest-face-id tie
rule holds under any row order.

Six wrappers, each of which launches its kernels on CUDA tensors, runs
its plain PyTorch version (`*_reference`, the same function) on CPU
tensors, and counts launches in `_build.LAUNCHES`:
  - `band_windows` -> `csrc/binning.cu` (bin_setup, then bin_windows:
    the setup, the band windows and the column masks, the raster
    kernels' inputs; its plain version is ops/binning.py's);
  - `shade_windows` -> `csrc/raster_shade.cu` (K1, inference: z-test +
    in-kernel shading); `rasterize_shaded` chains binning and K1;
  - `select_windows` -> `csrc/raster_select.cu` (K2, training forward:
    z-test + the winner's record fields and raster row);
  - `select_grad` -> `csrc/select_grad.cu` (K3, K2's adjoint: per raster
    row, the sum of its pixels' cotangent, by a counting sort of the
    winner rows);
  - `pos_windows` -> `csrc/raster_pos.cu` (K4, the z-test alone: winner
    face id, depth and raster row);
  - `texture_windows` -> `csrc/raster_texture.cu` (DECA's textured
    shade: K1's z-test, then SH-9 of the winner's interpolated world
    normal times a bilinear fetch of the image's UV albedo);
    `rasterize_textured` chains binning and it;
  - `texfetch_windows` -> `raster_texfetch_kernel`, the second kernel of
    `csrc/raster_texture.cu` (DECA's detailed image: K1's z-test, then a
    bilinear fetch of an already shaded UV texture at the winner's
    interpolated UV); `rasterize_texfetch` chains binning and it.
K1, K2, K4 and the two textured kernels share one micro-tiled z-test and block
skeleton (`csrc/raster_common.cuh`) and take one launch shape
(`_raster_ints`):
a block of 128 threads for each (column tile, band, image), for a band
of any size; a block walks its tile in pixel groups (`pixel_group`),
drops, per group, only triangles that cover none of the group's pixel
centers (`cull_keeps` is that cull's plain twin), and z-tests each
2 x 2 micro-tile only against the triangles that cover one of its
pixels (`microtile_mask` is the twin of those masks, `tests_issued`
counts the tests the kernels issue).
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
from facerecon_tpu_torch.profile_trace import span

_CHUNK = 128            # triangles per chunk (window-granularity unit)
_WINDOW = 64            # chunks covered by the column masks
_MWORDS = 2             # int32 chunk-mask words per (band, col)
_BGRP = 8               # row-count rounding shared with the reference
_ROW_PAD = 16           # setup record fields padded 12 -> 16
_FIELDS = 24            # render-attribute record width
_REF_ROWS = 8192        # rows per step of the plain version's window walk
_SEL = 20               # record fields the select returns per pixel
_GRAD = 17              # differentiable record fields
_MICRO = 2              # a kernel lane's micro-tile: 2 x 2 pixels
_COUNT_STEP = 8192      # (band, column, chunk) triples tests_issued takes
                        # at once
_BIN_COLS = 32          # column tiles the window pass takes (a warp each)


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
    cover a pixel.

    verts_ndc (B, N, 3) f32; row_faces (F, 3) and row_id (F,) int64 on
    the card. CPU tensors take the plain version
    (band_windows_reference, any index type); CUDA tensors launch
    `csrc/binning.cu`: the setup pass (bin_setup: the setup and each
    chunk's box, kept in a (B, chunks, 4) scratch) and the window pass
    (bin_windows: one warp a column tile, so n_cols <= 32), the same
    Windows bit for bit."""
    dev = verts_ndc.device
    if not _build.on_card(dev):
        return band_windows_reference(verts_ndc, row_faces, row_id, height,
                                      width, tile_h, n_cols, cull_backfaces)
    bsz, n_verts = verts_ndc.shape[:2]
    f = row_faces.shape[0]
    _build.check_tensors(dev, {
        "verts_ndc": (verts_ndc, torch.float32, (bsz, n_verts, 3)),
        "row_faces": (row_faces, torch.int64, (f, 3)),
        "row_id": (row_id, torch.int64, (f,)),
    })
    if not 1 <= n_cols <= _BIN_COLS:
        raise ValueError(f"the window pass takes 1 to {_BIN_COLS} column "
                         f"tiles, got {n_cols}")
    rows = padded_rows(f)
    n_chunks = (f + _CHUNK - 1) // _CHUNK
    n_bands = (height + tile_h - 1) // tile_h
    setup = torch.empty((bsz, _ROW_PAD, rows), dtype=torch.float32,
                        device=dev)
    boxes = torch.empty((bsz, n_chunks, 4), dtype=torch.float32, device=dev)
    blo = torch.empty((bsz, n_bands), dtype=torch.int32, device=dev)
    bn = torch.empty_like(blo)
    cmask = torch.empty((bsz, n_bands * n_cols * _MWORDS), dtype=torch.int32,
                        device=dev)
    if bsz:
        _build.launch("bin_setup", dev,
                      (verts_ndc, row_faces, row_id, setup, boxes),
                      (bsz, n_verts, f, rows, height, width,
                       int(cull_backfaces)))
        _build.launch("bin_windows", dev, (boxes, blo, bn, cmask),
                      (bsz, n_chunks, n_bands, tile_h, n_cols,
                       col_width(width, n_cols)))
    return Windows(blo=blo, bn=bn, cmask=cmask, setup=setup)


def band_windows_reference(verts_ndc, row_faces, row_id, height: int,
                           width: int, tile_h: int, n_cols: int,
                           cull_backfaces: bool = False) -> Windows:
    """Plain PyTorch version of band_windows (the binning kernels), on
    any device: ops/binning.bin_triangles_static_t, then the setup padded
    to padded_rows(F) rows with the face ids in field 12."""
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
    """The raster kernels' int arguments. K1, K2 and K4 launch alike: one
    block of 128 threads for each (column tile, band, image), with the
    windows' column masks as they are, for a band of any size (a block
    walks its column tile in pixel groups, `pixel_group`)."""
    bsz, _, rows = win.setup.shape
    n_bands = (height + tile_h - 1) // tile_h
    return (bsz, height, width, tile_h, n_cols, col_width(width, n_cols),
            n_bands, rows, n_faces)


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
    if bsz:
        _build.launch("raster_shade", dev, (win.setup, records, win.blo,
                                            win.bn, win.cmask, tri_id, color,
                                            bary),
                      _raster_ints(win, height, width, tile_h, n_cols,
                                   n_faces))
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
    if bsz:
        _build.launch("raster_select", dev, (win.setup, records, win.blo,
                                             win.bn, win.cmask, tri_id, row,
                                             sel),
                      _raster_ints(win, height, width, tile_h, n_cols,
                                   n_faces))
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
    if bsz:
        _build.launch("raster_pos", dev, (win.setup, win.blo, win.bn,
                                          win.cmask, tri_id, zbuf, row),
                      _raster_ints(win, height, width, tile_h, n_cols,
                                   n_faces))
    return tri_id, zbuf, row


def _check_texture(win: Windows, albedo, light, sh_factor):
    bsz = win.setup.shape[0]
    size = albedo.shape[1]
    _build.check_tensors(win.setup.device, {
        "albedo": (albedo, torch.float32, (bsz, size, size, 3)),
        "light": (light, torch.float32, (bsz, 9, 3)),
        "sh_factor": (sh_factor, torch.float32, (9,)),
    })


def texture_windows(win: Windows, records, albedo, light, sh_factor, *,
                    height: int, width: int, tile_h: int, n_cols: int,
                    n_faces: int):
    """Rasterize + DECA's textured shade from prepared windows: the
    textured kernel's wrapper.

    records (B, 24, rows) f32 in raster row order
    (render.pack_texture_records: world-normal corners 0..8, affine forms
    9..14, anchor 15..16, UV corners 17..22 in grid_sample coordinates);
    albedo (B, S, S, 3) f32 RGB; light (B, 9, 3) f32, DECA's SH
    coefficients; sh_factor (9,) DECA's constant factors. Returns (tri_id
    (B,H,W) int32, color (B,H,W,3) f32 = bilinear albedo x SH shading,
    zero on background, bary (B,H,W,3) f32). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_inputs(win, records, height, width, tile_h, n_cols)
    _check_texture(win, albedo, light, sh_factor)
    if not _build.on_card(records.device):
        return texture_windows_reference(
            win, records, albedo, light, sh_factor, height=height,
            width=width, tile_h=tile_h, n_cols=n_cols, n_faces=n_faces)
    bsz, dev = records.shape[0], records.device
    tri_id = torch.empty((bsz, height, width), dtype=torch.int32, device=dev)
    color = torch.empty((bsz, height, width, 3), dtype=torch.float32,
                        device=dev)
    bary = torch.empty_like(color)
    if bsz:
        _build.launch("raster_texture", dev,
                      (win.setup, records, win.blo, win.bn, win.cmask,
                       albedo, light, sh_factor, tri_id, color, bary),
                      (*_raster_ints(win, height, width, tile_h, n_cols,
                                     n_faces), albedo.shape[1]))
    return tri_id, color, bary


def texfetch_windows(win: Windows, records, texture, *, height: int,
                     width: int, tile_h: int, n_cols: int, n_faces: int):
    """Rasterize + the bilinear fetch of a shaded texture from prepared
    windows: the detailed image's kernel's wrapper. records as
    texture_windows takes them (only the affine forms, the anchor and the
    UV corners are read); texture (B, S, S, 3) f32 RGB, already shaded
    (ops/detail.uv_detail's uv_texture). Returns (tri_id (B,H,W) int32,
    color (B,H,W,3) f32 = grid_sample of the texture at the pixel's UV,
    zero on background, bary (B,H,W,3) f32). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_inputs(win, records, height, width, tile_h, n_cols)
    size = texture.shape[1]
    _build.check_tensors(win.setup.device, {
        "texture": (texture, torch.float32,
                    (win.setup.shape[0], size, size, 3))})
    if not _build.on_card(records.device):
        return texfetch_windows_reference(
            win, records, texture, height=height, width=width,
            tile_h=tile_h, n_cols=n_cols, n_faces=n_faces)
    bsz, dev = records.shape[0], records.device
    tri_id = torch.empty((bsz, height, width), dtype=torch.int32, device=dev)
    color = torch.empty((bsz, height, width, 3), dtype=torch.float32,
                        device=dev)
    bary = torch.empty_like(color)
    if bsz:
        _build.launch("raster_texfetch", dev,
                      (win.setup, records, win.blo, win.bn, win.cmask,
                       texture, tri_id, color, bary),
                      (*_raster_ints(win, height, width, tile_h, n_cols,
                                     n_faces), size))
    return tri_id, color, bary


def pixel_group(tile_h: int, col_w: int) -> tuple[int, int]:
    """(width, height) in pixels of the kernels' pixel group for a column
    tile of col_w x tile_h pixels (csrc/raster_common.cuh, tile_raster):
    gc x gr micro-tiles of 2 x 2 px, gc = min(micro-tile columns, 32), gr
    = min(micro-tile rows, 32 // gc). The groups tile the column tile from
    its top-left corner; the last row and column of groups may reach past
    it (their pixels there are tested, never written)."""
    mcols = (col_w + _MICRO - 1) // _MICRO
    mrows = (tile_h + _MICRO - 1) // _MICRO
    gc = min(mcols, 32)
    return gc * _MICRO, min(mrows, 32 // gc) * _MICRO


def _extents(f, x0, x1, y0, y1):
    """(hi0, hi1, lo0, lo1): the extremes of the edge forms e0 and e1 over
    the pixel centers of [x0, x1] x [y0, y1], as csrc/raster_common.cuh's
    cull_live computes them, in float32 op for op."""
    qxl, qxh = x0 - f[9], x1 - f[9]
    qyl, qyh = y0 - f[10], y1 - f[10]

    def ext(op, a, lo, hi):
        return op(a * lo, a * hi)
    hi0 = (ext(torch.maximum, f[0], qxl, qxh)
           + ext(torch.maximum, f[1], qyl, qyh)) + f[2]
    hi1 = (ext(torch.maximum, f[3], qxl, qxh)
           + ext(torch.maximum, f[4], qyl, qyh)) + f[5]
    lo0 = (ext(torch.minimum, f[0], qxl, qxh)
           + ext(torch.minimum, f[1], qyl, qyh)) + f[2]
    lo1 = (ext(torch.minimum, f[3], qxl, qxh)
           + ext(torch.minimum, f[4], qyl, qyh)) + f[5]
    return hi0, hi1, lo0, lo1


def cull_keeps(f, x0, x1, y0, y1):
    """The kernels' per-group triangle cull (csrc/raster_common.cuh,
    cull_live) in float32, op for op: False where the triangle with setup
    fields f[0..10] covers no pixel center of the rectangle [x0, x1] x
    [y0, y1] for certain, as the z-test's float ops decide coverage.
    Broadcasts over the fields' and the bounds' shapes."""
    hi0, hi1, lo0, lo1 = _extents(f, x0, x1, y0, y1)
    return ~((hi0 < 0) | (hi1 < 0) | (lo0 + lo1 > 1))


def microtile_mask(f, gx, gy, gc: int, gr: int, x_lim, y_lim):
    """(tested, hits): the micro-tiles of a pixel group on which the
    kernels test a triangle (csrc/raster_common.cuh, tile_hits), each
    (..., gr, gc) bool over the group's gr x gc micro-tiles of 2 x 2 px,
    first pixel (gx, gy) (ints or int tensors broadcasting with the
    fields f[k]), in float32 op for op. Micro-tile (i, j) is in the group
    if its first pixel lies before x_lim and y_lim (the first column and
    row past the tile and the image); its pixel centers are [gx + 2j, gx
    + 2j + 1] x [gy + 2i, gy + 2i + 1] + 0.5, its second row dropped where
    it lies at or past y_lim. `tested`: its rectangle passes cull_live's
    tests (cull_keeps) and the third edge's bound (edge_slack: the float
    form of (wa0 + wa1) qx + min_r fl(b0 + b1) + wc0 + wc1 - 1, at the
    pixel column nearer the side where it grows, against a slack of a few
    ulps);
    `hits`: the tested
    micro-tiles where the triangle covers one of its pixel centers, by
    the z-test's float ops. The kernels apply both to the triangles the
    group cull keeps (cull_keeps on the group's rectangle)."""
    dev = f.device
    j = torch.arange(gc, device=dev)
    i = torch.arange(gr, device=dev)[:, None]
    gx = torch.as_tensor(gx, device=dev)[..., None, None]
    gy = torch.as_tensor(gy, device=dev)[..., None, None]
    x_lim = torch.as_tensor(x_lim, device=dev)[..., None, None]
    y_lim = torch.as_tensor(y_lim, device=dev)[..., None, None]
    xt = gx + _MICRO * j                                   # (..., 1, gc)
    yt = gy + _MICRO * i                                   # (..., gr, 1)
    x0 = xt.to(torch.float32) + 0.5
    y0 = yt.to(torch.float32) + 0.5
    two = yt + 1 < y_lim
    y1 = torch.where(two, y0 + 1.0, y0)
    fe = f[..., None, None]
    # the third edge's bound (raster_common.cuh, edge_slack)
    b = [(fe[1] * (y - fe[10]), fe[4] * (y - fe[10])) for y in (y0, y1)]
    w = fe[0] + fe[3]
    k = ((torch.minimum(b[0][0] + b[0][1], b[1][0] + b[1][1]) + fe[2])
         + fe[5]) + -1.0
    bmax = torch.maximum(b[0][0].abs() + b[0][1].abs(),
                         b[1][0].abs() + b[1][1].abs())
    jn = torch.clamp((x_lim - gx + 1) // _MICRO, max=gc)
    first = gx.to(torch.float32) + 0.5
    last = (gx + _MICRO * (jn - 1) + 1).to(torch.float32) + 0.5
    qx_max = torch.maximum((first - fe[9]).abs(), (last - fe[9]).abs())
    u = 2.0 ** -24
    slack = (u + 12.0 * u * ((((fe[0].abs() + fe[3].abs()) * qx_max + bmax)
                              + (fe[2].abs() + fe[5].abs())) + 1.0)) + 1e-30
    qw = (x0 + torch.where(w > 0, 0.0, 1.0)) - fe[9]
    tested = (cull_keeps(fe, x0, x0 + 1.0, y0, y1) & ((w * qw + k) <= slack)
              & (xt < x_lim) & (yt < y_lim))
    hits = torch.zeros_like(tested)
    for r in range(_MICRO):
        qy = (y0 + float(r)) - fe[10]
        for c in range(_MICRO):
            qx = (x0 + float(c)) - fe[9]
            e0 = fe[0] * qx + fe[1] * qy + fe[2]
            e1 = fe[3] * qx + fe[4] * qy + fe[5]
            cov = (torch.minimum(e0, e1) >= 0.0) & (e0 + e1 <= 1.0)
            hits |= cov & (two if r else True)
    return tested, hits & tested


def tests_issued(win: Windows, *, height: int, width: int, tile_h: int,
                 n_cols: int) -> tuple[int, int]:
    """(mask tests, list tests): the pixel x triangle tests K1, K2 and K4
    issue on these windows (csrc/raster_common.cuh, tile_ztest). For
    each pixel group of each column tile (pixel_group; a group wholly
    past the tile or the image is skipped), each 32-row segment of each
    chunk the tile's walk visits (its masked chunks of the first 64, then
    every chunk beyond) issues, over its 32 lanes:
      - the coverage tests of tile_hits: a lane tests its triangle, if
        the group cull keeps it, on the pixels (2 a row) of each
        micro-tile microtile_mask's `tested` holds; the warp issues the
        most any lane makes;
      - the z-tests of test_list: a lane tests its micro-tile's pixels
        (4; 2 where the group is one pixel row of the tile) on each
        triangle whose `hits` hold it; the warp issues the longest list.
    _COUNT_STEP bounds the (band, column, chunk) triples evaluated at
    once."""
    col_w = col_width(width, n_cols)
    gw, gh = pixel_group(tile_h, col_w)
    gc, gr = gw // _MICRO, gh // _MICRO
    setup = win.setup
    bsz, _, rows = setup.shape
    n_bands = win.blo.shape[1]
    dev = setup.device
    lane = torch.arange(32, device=dev, dtype=torch.int64)
    words = win.cmask.view(bsz, n_bands, n_cols, _MWORDS).to(torch.int64)
    bits = ((words[..., None] >> lane) & 1).reshape(
        bsz, n_bands, n_cols, _MWORDS * 32).bool()
    k = torch.arange(max(_WINDOW, int(win.bn.max()) if bsz else 0),
                     device=dev)
    j = torch.arange(_CHUNK, device=dev)
    mask_tests = list_tests = 0
    for b in range(bsz):
        walked = torch.nn.functional.pad(bits[b], (0, k.numel() - _WINDOW))
        walked = walked | ((k >= _WINDOW) & (k < win.bn[b][:, None, None]))
        t_i, c_i, k_i = walked.nonzero(as_tuple=True)
        for s0 in range(0, t_i.numel(), _COUNT_STEP):
            step = slice(s0, s0 + _COUNT_STEP)
            t, c = t_i[step], c_i[step]
            r = ((win.blo[b][t] + k_i[step])[:, None] * _CHUNK
                 + j).clamp(max=rows - 1)                  # (N, 128)
            f = setup[b, :11][:, r]                        # (11, N, 128)
            x_tile, y_tile = c * col_w, t * tile_h
            x_lim = torch.clamp(x_tile + col_w, max=width)
            y_lim = torch.clamp(y_tile + tile_h, max=height)
            for gy in range(0, tile_h, gh):
                for gx in range(0, col_w, gw):
                    gx_px, gy_px = x_tile + gx, y_tile + gy
                    ok = (gx_px < x_lim) & (gy_px < y_lim)
                    if not bool(ok.any()):
                        continue
                    gx1 = torch.minimum(gx_px + gw, x_lim) - 1
                    gy1 = torch.minimum(gy_px + gh, y_lim) - 1
                    live = cull_keeps(
                        f, gx_px[:, None].to(torch.float32) + 0.5,
                        gx1[:, None].to(torch.float32) + 0.5,
                        gy_px[:, None].to(torch.float32) + 0.5,
                        gy1[:, None].to(torch.float32) + 0.5)
                    live = (live & ok[:, None])[..., None, None]
                    tested, hits = microtile_mask(
                        f, gx_px[:, None], gy_px[:, None], gc, gr,
                        x_lim[:, None], y_lim[:, None])
                    row_px = torch.where(
                        gy_px[:, None] + _MICRO * torch.arange(gr, device=dev)
                        + 1 < y_lim[:, None], 4, 2)        # (N, gr)
                    per_lane = ((tested & live).sum(dim=3)
                                * row_px[:, None]).sum(dim=2)  # (N, 128)
                    mask_tests += int(per_lane.reshape(-1, 4, 32).amax(
                        dim=2).sum()) * 32
                    per_tile = (hits & live).reshape(-1, 4, 32,
                                                     gr * gc).sum(dim=2)
                    pixels = torch.where(y_lim - gy_px == 1, 2, 4)
                    list_tests += int((per_tile.amax(dim=2)
                                       * pixels[:, None]).sum()) * 32
    return mask_tests, list_tests


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


def bilinear_zeros(tex, gx, gy):
    """F.grid_sample(bilinear, zeros padding, align_corners=False) of one
    image's texture tex (S, S, C) at grid coordinates gx, gy (P,), with
    PyTorch's float32 ops in its order: the corner weights from the
    unnormalised position, then nw, ne, sw, se added to 0 in that order,
    a corner outside the texture adding nothing. Returns (P, C)."""
    size = tex.shape[0]
    flat = tex.reshape(size * size, -1)
    ix = ((gx + 1.0) * size - 1.0) / 2.0
    iy = ((gy + 1.0) * size - 1.0) / 2.0
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    x1, y1 = x0 + 1.0, y0 + 1.0
    acc = torch.zeros((gx.shape[0], flat.shape[1]), device=tex.device)
    for xs, ys, wgt in ((x0, y0, (x1 - ix) * (y1 - iy)),
                        (x1, y0, (ix - x0) * (y1 - iy)),
                        (x0, y1, (x1 - ix) * (iy - y0)),
                        (x1, y1, (ix - x0) * (iy - y0))):
        inb = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
        at = (ys.clamp(0, size - 1) * size + xs.clamp(0, size - 1)).to(
            torch.int64)
        acc = acc + torch.where(inb[:, None], flat[at] * wgt[:, None], 0.0)
    return acc


def texture_windows_reference(win: Windows, records, albedo, light,
                              sh_factor, *, height: int, width: int,
                              tile_h: int, n_cols: int, n_faces: int):
    """Plain PyTorch version of the textured kernel, on the same inputs:
    the plain z-test (_band_winners), then the winner's barycentrics,
    world normal and UV, SH-9 shading (DECA's basis [1, x, y, z, xy, xz,
    yz, x^2 - y^2, 3z^2 - 1] times sh_factor, dotted with the light in
    order) and the bilinear albedo (bilinear_zeros), with the kernel's
    float ops in its order."""
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
        rec = records[b, :23, best_row]                # (23, band_px)
        qx = px - rec[15]
        qy = py - rec[16]
        w0 = rec[9] * qx + rec[10] * qy + rec[11]
        w1 = rec[12] * qx + rec[13] * qy + rec[14]
        w2 = 1.0 - w0 - w1

        def lerp(f, step):
            return w0 * rec[f] + w1 * rec[f + step] + w2 * rec[f + 2 * step]
        nx, ny, nz = lerp(0, 3), lerp(1, 3), lerp(2, 3)
        basis = (torch.ones_like(nx), nx, ny, nz, nx * ny, nx * nz, ny * nz,
                 nx * nx - ny * ny, 3.0 * (nz * nz) - 1.0)
        shading = []
        for c in range(3):
            acc = (basis[0] * sh_factor[0]) * light[b, 0, c]
            for k in range(1, 9):
                acc = acc + (basis[k] * sh_factor[k]) * light[b, k, c]
            shading.append(acc)
        tex = bilinear_zeros(albedo[b], lerp(17, 2), lerp(18, 2))
        rgb = tex * torch.stack(shading, -1)
        hit3 = hit[:, None]
        tri[b, t] = torch.where(hit, ids, -1).to(torch.int32)
        color[b, t] = torch.where(hit3, rgb, 0.0)
        bary[b, t] = torch.where(hit3, torch.stack([w0, w1, w2], -1), 0.0)
    return tuple(_unband(a, height, width, tile_h)
                 for a in (tri, color, bary))


def texfetch_windows_reference(win: Windows, records, texture, *,
                               height: int, width: int, tile_h: int,
                               n_cols: int, n_faces: int):
    """Plain PyTorch version of the detailed image's fetch kernel, on the
    same inputs: the plain z-test (_band_winners), the winner's
    barycentrics and UV, and the bilinear fetch of the shaded texture
    (bilinear_zeros), with the kernel's float ops in its order."""
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
        rec = records[b, :23, best_row]                # (23, band_px)
        qx = px - rec[15]
        qy = py - rec[16]
        w0 = rec[9] * qx + rec[10] * qy + rec[11]
        w1 = rec[12] * qx + rec[13] * qy + rec[14]
        w2 = 1.0 - w0 - w1

        def lerp(f):
            return w0 * rec[f] + w1 * rec[f + 2] + w2 * rec[f + 4]
        rgb = bilinear_zeros(texture[b], lerp(17), lerp(18))
        hit3 = hit[:, None]
        tri[b, t] = torch.where(hit, ids, -1).to(torch.int32)
        color[b, t] = torch.where(hit3, rgb, 0.0)
        bary[b, t] = torch.where(hit3, torch.stack([w0, w1, w2], -1), 0.0)
    return tuple(_unband(a, height, width, tile_h)
                 for a in (tri, color, bary))


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
    windows (checked, unused: a counting sort needs no window). Returns
    d_rec (B, 24, rows) f32: per raster row, the sum of its pixels'
    cotangent for fields 0..16 in ascending pixel order, zero for fields
    17..23. Deterministic on the card (int atomics only). CPU tensors
    take the plain version; CUDA tensors launch the kernel, with its
    scratch: per-row offsets (B, rows) and two (B, H*W) pixel lists."""
    _check_grad_inputs(row, g, blo, bn, rows, tile_h)
    if not _build.on_card(g.device):
        return select_grad_reference(row, g, blo, bn, rows=rows,
                                     tile_h=tile_h)
    bsz, height, width = row.shape
    dev = g.device
    d_rec = torch.empty((bsz, _FIELDS, rows), dtype=torch.float32,
                        device=dev)
    offsets = torch.empty((bsz, rows), dtype=torch.int32, device=dev)
    pixels = torch.empty((2, bsz, height * width), dtype=torch.int32,
                         device=dev)
    if bsz:
        _build.launch("select_grad", dev,
                      (row, g, d_rec, offsets, pixels[0], pixels[1]),
                      (bsz, height * width, rows))
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
               n_cols, cull_backfaces, row_faces, row_id):
    row_faces, row_id = _row_order(faces, row_faces, row_id)
    with torch.no_grad():
        with span("fr.binning"):
            win = band_windows(verts_ndc, row_faces, row_id, height, width,
                               tile_h, n_cols, cull_backfaces)
        return core(win, records.contiguous(), height=height, width=width,
                    tile_h=tile_h, n_cols=n_cols, n_faces=faces.shape[0])


def rasterize_shaded(records, verts_ndc, faces, *, height: int, width: int,
                     tile_h: int, n_cols: int = 1,
                     cull_backfaces: bool = False, row_faces=None,
                     row_id=None):
    """Fused raster + in-kernel shading, the inference hot path.

    records (B, 24, padded_rows(F')) f32 in raster row order; verts_ndc
    (B, N, 3); faces (F, 3); row_faces/row_id the static raster row order
    (identity when None); cull_backfaces drops the faces of positive
    screen area in the binning. Returns (tri_id (B,H,W) int32, color
    (B,H,W,3) f32, bary (B,H,W,3) f32). Runs on the device of its inputs;
    no gradients."""
    return _rasterize(shade_windows, records, verts_ndc, faces, height,
                      width, tile_h, n_cols, cull_backfaces, row_faces,
                      row_id)


def rasterize_shaded_reference(records, verts_ndc, faces, *, height: int,
                               width: int, tile_h: int, n_cols: int = 1,
                               cull_backfaces: bool = False, row_faces=None,
                               row_id=None):
    """rasterize_shaded through the plain version on any device."""
    return _rasterize(shade_windows_reference, records, verts_ndc, faces,
                      height, width, tile_h, n_cols, cull_backfaces,
                      row_faces, row_id)


def rasterize_textured(records, albedo, light, sh_factor, verts_ndc, faces,
                       *, height: int, width: int, tile_h: int,
                       n_cols: int = 1, cull_backfaces: bool = False,
                       row_faces=None, row_id=None):
    """Fused raster + DECA's textured shade (the FLAME inference path):
    binning, then texture_windows. records (B, 24, padded_rows(F')) from
    render.pack_texture_records; albedo (B, S, S, 3); light (B, 9, 3);
    sh_factor (9,); the rest as rasterize_shaded. Returns (tri_id, color,
    bary) as rasterize_shaded."""
    def core(win, rec, **kw):
        return texture_windows(win, rec, albedo, light, sh_factor, **kw)
    return _rasterize(core, records, verts_ndc, faces, height, width,
                      tile_h, n_cols, cull_backfaces, row_faces, row_id)


def rasterize_texfetch(records, texture, verts_ndc, faces, *, height: int,
                       width: int, tile_h: int, n_cols: int = 1,
                       cull_backfaces: bool = False, row_faces=None,
                       row_id=None):
    """Fused raster + the bilinear fetch of a shaded UV texture (DECA's
    detailed image): binning, then texfetch_windows. records as
    rasterize_textured; texture (B, S, S, 3). Returns (tri_id, color,
    bary) as rasterize_shaded."""
    def core(win, rec, **kw):
        return texfetch_windows(win, rec, texture, **kw)
    return _rasterize(core, records, verts_ndc, faces, height, width,
                      tile_h, n_cols, cull_backfaces, row_faces, row_id)


def rasterize_select(records, verts_ndc, faces, *, height: int, width: int,
                     tile_h: int, n_cols: int = 1,
                     cull_backfaces: bool = False, row_faces=None,
                     row_id=None):
    """Fused raster + winner-record select, the training render's hot
    path (twin of the reference's rasterize_select).

    records (B, 24, padded_rows(F')) f32 in raster row order; verts_ndc
    (B, N, 3); faces (F, 3); row_faces/row_id the static raster row order
    (identity when None); cull_backfaces as in rasterize_shaded. Returns
    (tri_id (B,H,W) int32, row (B,H,W) int32, sel (B,20,H,W) f32). Differentiable in `records` only:
    `verts_ndc` is detached (the binning and the z-test carry no
    gradient) and tri_id is frozen."""
    row_faces, row_id = _row_order(faces, row_faces, row_id)
    with torch.no_grad(), span("fr.binning"):
        win = band_windows(verts_ndc.detach(), row_faces, row_id, height,
                           width, tile_h, n_cols, cull_backfaces)
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
