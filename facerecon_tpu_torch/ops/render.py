"""Render path (twin of the inference path of facerecon_tpu/ops/render.py).

Per-face render records (radiance corners + the anchored affine forms
that give the barycentrics) feed the fused rasterize+shade kernel, and
the shaded face is composited over the background. Only the forward-only
inference path exists in this port so far.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from facerecon_tpu_torch.config import FaceReconConfig
from facerecon_tpu_torch.ops import rasterize
from facerecon_tpu_torch.ops import sh as sh_ops
from facerecon_tpu_torch.ops.binning import affine_forms, ndc_to_screen
from facerecon_tpu_torch.ops.geometry import (DeviceBFM, Geometry,
                                              coeffs_to_geometry)
from facerecon_tpu_torch.utils.coeffs import Coeffs


def _render_fields(verts_ndc, radiance, faces, height: int, width: int):
    """Corner gather + anchored affine forms -> 17 (B, F) field blocks
    [radiance corners r00..r22 (9, corner-major) | affine w-coefficients
    wa0, wb0, wc0, wa1, wb1, wc1 | anchor x0, y0]. The affine forms use
    the rasterizer setup's float ops, so the barycentrics rebuilt from a
    pixel's winner record equal the rasterizer's exactly."""
    screen = ndc_to_screen(verts_ndc, height, width)          # (B,N,2)
    f = faces.shape[0]
    planes = (radiance[..., 0], radiance[..., 1], radiance[..., 2],
              screen[..., 0], screen[..., 1])                 # (B, N) x5
    idx = faces.T.reshape(-1)                                 # corner-major
    corners = tuple(p[:, idx] for p in planes)

    def fld(c, k):
        return corners[k][:, c * f:(c + 1) * f]               # (B, F)

    p0 = torch.stack([fld(0, 3), fld(0, 4)], dim=-1)          # (B, F, 2)
    p1 = torch.stack([fld(1, 3), fld(1, 4)], dim=-1)
    p2 = torch.stack([fld(2, 3), fld(2, 4)], dim=-1)
    wa0, wb0, wc0, wa1, wb1, wc1, _ = affine_forms(p0, p1, p2)
    rad = [fld(c, k) for c in range(3) for k in range(3)]     # radiance
    return (*rad, wa0, wb0, wc0, wa1, wb1, wc1, fld(0, 3), fld(0, 4))


def _stack24(fields, pad_rows: int):
    """(B, 24, pad_rows) f32 field-major record from the 17 field blocks:
    [radiance 9 | w-coeffs 6 | anchor x0,y0 | zero 7], zero-padded rows."""
    b, f = fields[0].shape
    rec = fields[0].new_zeros((b, rasterize._FIELDS, pad_rows))
    rec[:, :len(fields), :f] = torch.stack(fields, dim=1)
    return rec


def pack_render_records(verts_ndc, radiance, faces, height: int, width: int,
                        pad_rows: int):
    """Per-face render attributes, field-major (B, 24, pad_rows) f32 —
    _render_fields + _stack24. The kernel reads the winner's f32 fields
    directly (the reference's hi/lo bf16 split exists only for the TPU's
    bf16 matrix unit)."""
    return _stack24(_render_fields(verts_ndc, radiance, faces, height,
                                   width), pad_rows)


def _require_inference(inference: bool) -> None:
    if not inference:
        raise NotImplementedError(
            "the differentiable training render is not ported yet "
            "(ROADMAP.md queue A, item 'Training path'); pass "
            "inference=True")


class RenderOut(NamedTuple):
    image: torch.Tensor       # (B,H,W,3) composited render
    mask: torch.Tensor        # (B,H,W) coverage (1 = face)
    tri_id: torch.Tensor      # (B,H,W) int32
    bary: torch.Tensor        # (B,H,W,3) barycentrics
    radiance: torch.Tensor    # (B,N,3) per-vertex shaded color
    geometry: Geometry
    skin: Optional[torch.Tensor] = None  # training path only


def render_geometry(geom: Geometry, gamma, bfm: DeviceBFM,
                    cfg: FaceReconConfig,
                    background: Optional[torch.Tensor] = None,
                    image_size: Optional[int] = None,
                    inference: bool = False) -> RenderOut:
    _require_inference(inference)
    h = w = image_size or cfg.image_size
    radiance = sh_ops.illuminate(geom.texture, geom.normals, gamma)
    records = pack_render_records(
        geom.verts_ndc, radiance, bfm.raster_rows, h, w,
        rasterize.padded_rows(bfm.raster_rows.shape[0]))
    tri_id, color, bary = rasterize.rasterize_shaded(
        records, geom.verts_ndc, bfm.faces, height=h, width=w,
        tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
        row_faces=bfm.raster_rows, row_id=bfm.raster_row_id)
    mask = (tri_id >= 0).to(torch.float32)
    if background is None:
        background = torch.zeros_like(color)
    image = color * mask[..., None] + background * (1.0 - mask[..., None])
    return RenderOut(image=image, mask=mask, tri_id=tri_id, bary=bary,
                     radiance=radiance, geometry=geom)


def render_coeffs(coeffs: Coeffs, bfm: DeviceBFM, cfg: FaceReconConfig,
                  background: Optional[torch.Tensor] = None,
                  image_size: Optional[int] = None,
                  inference: bool = False) -> RenderOut:
    """Coefficients -> composited image. Only inference=True (the
    forward-only in-kernel-shaded path) is ported."""
    _require_inference(inference)
    geom = coeffs_to_geometry(coeffs, bfm, cfg)
    return render_geometry(geom, coeffs.gamma, bfm, cfg,
                           background=background, image_size=image_size,
                           inference=inference)
