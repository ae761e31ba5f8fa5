"""Triangle setup + static band/column binning (twin of the parts of
facerecon_tpu/ops/binning.py and ops/rasterize_jnp.py that the inference
rasterizer uses).

Per-triangle setup precomputes the affine forms ANCHORED at vertex 0
(evaluated at q = pixel - (x0, y0)):
  w0(q) = wa0*qx + wb0*qy + wc0      (barycentric of vertex 0)
  w1(q) = wa1*qx + wb1*qy + wc1
  w2    = 1 - w0 - w1
  z (q) = za*qx  + zb*qy  + z0       (screen-space linear depth)
Coverage is w0>=0 & w1>=0 & w0+w1<=1. Degenerate triangles get
wc0 = wc1 = -3e38 so they never cover a pixel. Every value is computed
with the same float32 operations in the same order as the reference, so
the setup, windows and masks come out bit-identical.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_NEG = -3e38  # effectively -inf in f32, kills coverage for dead triangles
_BIG = 3e38


def ndc_to_screen(verts_ndc, height: int, width: int):
    u = (verts_ndc[..., 0] + 1.0) * (width / 2.0)
    v = (1.0 - verts_ndc[..., 1]) * (height / 2.0)
    return torch.stack([u, v], dim=-1)


def affine_forms(p0, p1, p2, dead=None):
    """Vertex-0-anchored barycentric affine forms from screen corners.

    p0/p1/p2 (..., 2) screen positions -> (wa0, wb0, wc0, wa1, wb1, wc1,
    area) with w0(q) = wa0 qx + wb0 qy + wc0 evaluated at q = pixel - p0.
    Shared by the rasterizer setup and the render-record pack (same float
    ops -> identical values)."""
    u1 = p1[..., 0] - p0[..., 0]
    v1 = p1[..., 1] - p0[..., 1]
    u2 = p2[..., 0] - p0[..., 0]
    v2 = p2[..., 1] - p0[..., 1]
    area = u1 * v2 - v1 * u2
    dead_a = torch.abs(area) <= 1e-12
    if dead is not None:
        dead_a = dead_a | dead
    inv_area = torch.where(dead_a, 0.0,
                           1.0 / torch.where(dead_a, 1.0, area))
    wa0 = (v1 - v2) * inv_area
    wb0 = (u2 - u1) * inv_area
    wc0 = (u1 * v2 - u2 * v1) * inv_area   # = 1.0 up to rounding
    wa1 = v2 * inv_area
    wb1 = -u2 * inv_area
    wc1 = torch.zeros_like(wa1)
    return wa0, wb0, wc0, wa1, wb1, wc1, area


class StaticSetupT(NamedTuple):
    coeffs_t: tuple            # 12 (B, F) f32 field rows
    band_lo: torch.Tensor      # (B, n_bands) int32 band union first chunk
    n_chunks: torch.Tensor     # (B, n_bands) int32 band union chunk count
    chunk_mask: torch.Tensor   # (B, n_bands, n_cols, mask_words) int32:
                               # bit i of word w set iff chunk
                               # band_lo + 32*w + i hits the (band, col)
                               # tile; chunks beyond 32*mask_words are
                               # tested without a mask


def _argmax_first(x, dim):
    """Index of the first True along dim (0 when none): torch.argmax on
    an integer tensor returns the first maximal index, as JAX does."""
    return torch.argmax(x.to(torch.int32), dim=dim)


def bin_triangles_static_t(verts_ndc, faces, height: int, width: int,
                           tile_h: int, chunk: int,
                           cull_backfaces: bool = False,
                           tile_w: int = 128,
                           mask_words: int = 2) -> StaticSetupT:
    """Field-major triangle setup + band union windows + EXACT per-chunk
    column masks (twin of the reference's bin_triangles_static_t).
    cull_backfaces also kills every triangle of positive screen area
    (the reference's rule, with y pointing down).

    The masks are packed bit-parallel: the absolute chunk-hit matrix goes
    into 32-bit words (held in int64, since torch has little uint32
    arithmetic), and each band's window words are cut out with a 3-word
    gather and a funnel shift, then reinterpreted as int32 two's
    complement."""
    bsz = verts_ndc.shape[0]
    f = faces.shape[0]
    dev = verts_ndc.device
    screen = ndc_to_screen(verts_ndc, height, width)          # (B,N,2)
    idx = faces.T.reshape(-1)                                 # corner-major
    planes = (screen[..., 0], screen[..., 1], verts_ndc[..., 2])
    corners = tuple(p[:, idx] for p in planes)

    def fld(c, k):
        return corners[k][:, c * f:(c + 1) * f]               # (B, F)

    x0, y0, z0 = fld(0, 0), fld(0, 1), fld(0, 2)
    x1, y1, z1 = fld(1, 0), fld(1, 1), fld(1, 2)
    x2, y2, z2 = fld(2, 0), fld(2, 1), fld(2, 2)

    u1 = x1 - x0
    v1 = y1 - y0
    u2 = x2 - x0
    v2 = y2 - y0
    area = u1 * v2 - v1 * u2
    dead = torch.abs(area) <= 1e-12
    if cull_backfaces:
        dead = dead | (area > 0)
    inv_area = torch.where(dead, 0.0, 1.0 / torch.where(dead, 1.0, area))
    wa0 = (v1 - v2) * inv_area
    wb0 = (u2 - u1) * inv_area
    wc0 = (u1 * v2 - u2 * v1) * inv_area
    wa1 = v2 * inv_area
    wb1 = -u2 * inv_area
    wc1 = torch.zeros_like(wa1)
    za = wa0 * (z0 - z2) + wa1 * (z1 - z2)
    zb = wb0 * (z0 - z2) + wb1 * (z1 - z2)
    wc0 = torch.where(dead, _NEG, wc0)
    wc1 = torch.where(dead, _NEG, wc1)
    wa0 = torch.where(dead, 0.0, wa0)
    wb0 = torch.where(dead, 0.0, wb0)
    wa1 = torch.where(dead, 0.0, wa1)
    wb1 = torch.where(dead, 0.0, wb1)

    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.where(dead, _BIG, ymin)
    ymax = torch.where(dead, -_BIG, ymax)
    xmin = torch.where(dead, _BIG, xmin)
    xmax = torch.where(dead, -_BIG, xmax)

    coeffs_t = (wa0, wb0, wc0, wa1, wb1, wc1, za, zb, z0, x0, y0, ymin)

    pad = (-f) % chunk
    nct = (f + pad) // chunk

    def chunk_reduce(a, fill, red):
        a = torch.nn.functional.pad(a, (0, pad), value=fill)
        return red(a.reshape(bsz, nct, chunk), dim=2)

    cymin = chunk_reduce(ymin, _BIG, torch.amin)              # (B, nct)
    cymax = chunk_reduce(ymax, -_BIG, torch.amax)
    cxmin = chunk_reduce(xmin, _BIG, torch.amin)
    cxmax = chunk_reduce(xmax, -_BIG, torch.amax)

    n_bands = (height + tile_h - 1) // tile_h
    n_cols = (width + tile_w - 1) // tile_w
    band_tops = torch.arange(n_bands, device=dev, dtype=torch.float32) * tile_h
    col_lefts = torch.arange(n_cols, device=dev, dtype=torch.float32) * tile_w
    hit_y = ((cymin[:, None] <= (band_tops + tile_h)[None, :, None])
             & (cymax[:, None] >= band_tops[None, :, None]))
    hit_x = ((cxmin[:, None] <= (col_lefts + tile_w)[None, :, None])
             & (cxmax[:, None] >= col_lefts[None, :, None]))
    hit = hit_y[:, :, None] & hit_x[:, None]      # (B, bands, cols, nct)
    any_hit = torch.any(hit, dim=3)
    first = _argmax_first(hit, 3)
    last = nct - 1 - _argmax_first(hit.flip(3), 3)
    # band UNION span over columns
    ulo = torch.amin(torch.where(any_hit, first, 2 ** 30), dim=2)
    uhi = torch.amax(torch.where(any_hit, last + 1, 0), dim=2)
    any_b = torch.any(any_hit, dim=2)
    ulo = torch.where(any_b, ulo, 0)                          # (B, bands)
    un = torch.where(any_b, uhi - ulo, 0)

    # EXACT per-chunk bitmask, window-relative
    nw = (nct + 31) // 32
    hit_p = torch.nn.functional.pad(hit, (0, nw * 32 - nct))
    lane_bit = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    words = (hit_p.reshape(bsz, n_bands, n_cols, nw, 32).to(torch.int64)
             * lane_bit).sum(dim=-1)                 # (B, bands, cols, nw)
    q = (ulo >> 5)[:, :, None, None].to(torch.int64)
    s = (ulo & 31)[:, :, None, None].to(torch.int64)
    k = torch.arange(mask_words + 1, device=dev, dtype=torch.int64)
    gi = torch.clamp(q + k, 0, nw - 1)
    gw = torch.gather(words, 3, gi.expand(bsz, n_bands, n_cols,
                                          mask_words + 1))
    gw = torch.where(q + k < nw, gw, 0)
    lo_part = gw[..., :mask_words] >> s
    hi_part = torch.where(s == 0, 0,
                          (gw[..., 1:] << (32 - s)) & 0xFFFFFFFF)
    m = lo_part | hi_part                            # in [0, 2^32)
    chunk_mask = torch.where(m >= 2 ** 31, m - 2 ** 32, m).to(torch.int32)
    return StaticSetupT(coeffs_t=coeffs_t, band_lo=ulo.to(torch.int32),
                        n_chunks=un.to(torch.int32), chunk_mask=chunk_mask)
