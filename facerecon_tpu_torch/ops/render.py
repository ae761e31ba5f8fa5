"""Render path (twin of facerecon_tpu/ops/render.py).

Per-face render records (radiance corners + the anchored affine forms
that give the barycentrics) feed the fused rasterizers, and the shaded
face is composited over the background. Two paths:

- inference=True: forward only. The kernel K1 (`rasterize_shaded`)
  shades in-kernel. Under no_grad the geometry comes from the geometry
  kernel with its radiance (ops/geometry.vertex_pass), so there is no
  separate SH pass, and the records from the record kernel
  (`pack_records`, csrc/records.cu: one launch in place of ~40 eager
  ops). Both record packs take the kernel where autograd records
  nothing on their inputs and they lie on the card, and their plain
  versions (`*_reference`, _render_fields + _stack24) elsewhere.
- inference=False: the differentiable training render. K2
  (`rasterize_select`) returns each pixel's winner record fields, and
  `_shade_from_sel` rebuilds color, barycentrics and the skin mask from
  them with differentiable ops; K3 is the select's adjoint. Gradients
  reach the vertices through the records' affine forms (dL/dV_xy) and
  the radiance corners; tri_id is frozen and depth gets none (SURVEY
  §9.6). Its records are always the eager ops (_render_fields with the
  corner adjacency, _stack24 with the skin rows).

Given a FLAME config, DECA's codes and FLAME device assets
(ops/flame.DeviceFLAME), `render_coeffs` renders DECA's coarse model
instead (`render_flame`, inference only): FLAME's geometry, the UV
albedo decode, and the textured raster (`rasterize.rasterize_textured`),
whose kernel shades each pixel from its winner's world normals and UVs
with SH-9 and a bilinear fetch of the albedo (`pack_texture_records`).
A detail config (cfg.n_detail > 0, DECA's detail model; the pack holds
its tables and decoder, ops/detail.DeviceDetail) decodes the
displacement map (models/deca_detail, span fr.decoder), shades the UV
texture from the detail normals (ops/detail.uv_detail, fr.uv_detail),
and fetches the detailed image from it (`rasterize.rasterize_texfetch`).

Given a GaussianAvatars config (cfg.model == "gavatar"), a frame's
AvatarCodes and an ops/gavatar.DeviceAvatar, `render_coeffs` splats the
avatar instead (`render_avatar`, inference only): FLAME under the full
pose (fr.flame, a CUDA graph on the card), the Gaussians' preprocess
(fr.gaussians), the pairs' emit, sort and tile ranges (fr.splat_sort)
and the blend (fr.splat), into a cfg.render_hw image; its mask is the
alpha 1 - T.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from facerecon_tpu_torch.config import (FaceReconConfig, is_flame,
                                       is_gavatar)
from facerecon_tpu_torch.models.deca_detail import decoder_input
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops import flame as flame_ops
from facerecon_tpu_torch.ops import gavatar as gavatar_ops
from facerecon_tpu_torch.ops import rasterize
from facerecon_tpu_torch.ops import sh as sh_ops
from facerecon_tpu_torch.ops.binning import affine_forms, ndc_to_screen
from facerecon_tpu_torch.ops.detail import uv_detail
from facerecon_tpu_torch.ops.geometry import (DeviceBFM, Geometry,
                                              autograd_records,
                                              coeffs_to_geometry,
                                              take_corner_planes)
from facerecon_tpu_torch.profile_trace import span
from facerecon_tpu_torch.utils.coeffs import Coeffs

_N_FIELDS = 17          # fields _render_fields computes; the tail follows


def _render_fields(verts_ndc, radiance, faces, height: int, width: int,
                   corner_adj=None):
    """Corner gather + anchored affine forms -> 17 (B, F) field blocks
    [radiance corners r00..r22 (9, corner-major) | affine w-coefficients
    wa0, wb0, wc0, wa1, wb1, wc1 | anchor x0, y0]. The affine forms use
    the rasterizer setup's float ops, so the barycentrics rebuilt from a
    pixel's winner record equal the rasterizer's exactly.

    corner_adj: the corner-major adjacency matching `faces`
    (DeviceBFM.raster_corner_adj for the raster rows); when given, the
    corner gather's adjoint is a gather too (take_corner_planes)."""
    screen = ndc_to_screen(verts_ndc, height, width)          # (B,N,2)
    f = faces.shape[0]
    planes = (radiance[..., 0], radiance[..., 1], radiance[..., 2],
              screen[..., 0], screen[..., 1])                 # (B, N) x5
    idx = faces.T.reshape(-1)                                 # corner-major
    if corner_adj is None:
        corners = tuple(p[:, idx] for p in planes)
    else:
        corners = take_corner_planes(planes, idx, corner_adj)

    def fld(c, k):
        return corners[k][:, c * f:(c + 1) * f]               # (B, F)

    p0 = torch.stack([fld(0, 3), fld(0, 4)], dim=-1)          # (B, F, 2)
    p1 = torch.stack([fld(1, 3), fld(1, 4)], dim=-1)
    p2 = torch.stack([fld(2, 3), fld(2, 4)], dim=-1)
    wa0, wb0, wc0, wa1, wb1, wc1, _ = affine_forms(p0, p1, p2)
    rad = [fld(c, k) for c in range(3) for k in range(3)]     # radiance
    return (*rad, wa0, wb0, wc0, wa1, wb1, wc1, fld(0, 3), fld(0, 4))


def _stack24(fields, pad_rows: int, skin=None):
    """(B, 24, pad_rows) f32 field-major record from the 17 field blocks:
    [radiance 9 | w-coeffs 6 | anchor x0,y0 | skin corners 3 | zero 4],
    zero-padded rows. skin: optional static (3, F) per-corner skin mask
    (DeviceBFM.raster_skin) for the training record; the select delivers
    each pixel's winner skin corners, and they carry no gradient."""
    b, f = fields[0].shape
    rec = fields[0].new_zeros((b, rasterize._FIELDS, pad_rows))
    rec[:, :len(fields), :f] = torch.stack(fields, dim=1)
    if skin is not None:
        rec[:, len(fields):len(fields) + 3, :f] = skin
    return rec


def pack_records(verts_ndc, attr, rows, height: int, width: int,
                 pad_rows: int, tail=None):
    """The record kernel (`csrc/records.cu`, one launch): the (B, 24,
    pad_rows) f32 field-major record [attribute corners 9 (corner-major)
    | affine forms 6 | anchor x0, y0 | tail | zero], zero past the F' raster
    rows, bit for bit what _render_fields + _stack24 give. attr (B, N, 3)
    is the radiance (BFM) or the world normals (DECA); tail, where given,
    is a static (T, F') f32 block of fields 17..17+T-1, T <= 7. It has no
    backward. Everything on the card, f32 and contiguous, the rows int64,
    or it raises."""
    dev = verts_ndc.device
    if dev.type != "cuda":
        raise ValueError(f"the record kernel runs on the card, not {dev}")
    if verts_ndc.dim() != 3 or rows.dim() != 2:
        raise ValueError(f"expected verts_ndc (B, N, 3) and rows (F', 3), "
                         f"got {tuple(verts_ndc.shape)} and "
                         f"{tuple(rows.shape)}")
    bsz, n_verts = verts_ndc.shape[:2]
    f = rows.shape[0]
    f32 = torch.float32
    want = {"verts_ndc": (verts_ndc, f32, (bsz, n_verts, 3)),
            "attr": (attr, f32, (bsz, n_verts, 3)),
            "rows": (rows, torch.int64, (f, 3))}
    n_tail = 0
    if tail is not None:
        n_tail = tail.shape[0] if tail.dim() == 2 else 0
        if not 1 <= n_tail <= rasterize._FIELDS - _N_FIELDS:
            raise ValueError(f"tail: expected 1 to "
                             f"{rasterize._FIELDS - _N_FIELDS} rows of "
                             f"{f}, got {tuple(tail.shape)}")
        want["tail"] = (tail, f32, (n_tail, f))
    _build.check_tensors(dev, want)
    if pad_rows < f or bsz > 65535:
        raise ValueError(f"expected F' = {f} <= pad_rows = {pad_rows} and "
                         f"at most 65535 images, got {bsz}")
    rec = torch.empty((bsz, rasterize._FIELDS, pad_rows), dtype=f32,
                      device=dev)
    if bsz and pad_rows:
        # without a tail the kernel reads none: any pointer will do
        _build.launch("records", dev,
                      (verts_ndc, attr, rows,
                       tail if tail is not None else rec, rec),
                      (bsz, n_verts, f, pad_rows, n_tail, height, width))
    return rec


def _records_kernel_takes(verts_ndc, attr) -> bool:
    """Whether the record kernel builds this record: the tensors on the
    card and autograd recording nothing on them (the kernel has no
    backward)."""
    return (_build.on_card(verts_ndc.device)
            and not autograd_records(verts_ndc, attr))


def pack_render_records(verts_ndc, radiance, faces, height: int, width: int,
                        pad_rows: int):
    """Per-face render attributes, field-major (B, 24, pad_rows) f32:
    [radiance corners 9 | affine forms 6 | anchor x0, y0 | zero 7], zero
    past the F' rows. The record kernel (pack_records) where it takes
    them (on the card, autograd recording nothing), else the plain
    version. The kernels read the winner's f32 fields directly (the
    reference's hi/lo bf16 split exists only for the TPU's bf16 matrix
    unit)."""
    if _records_kernel_takes(verts_ndc, radiance):
        return pack_records(verts_ndc, radiance, faces, height, width,
                            pad_rows)
    return pack_render_records_reference(verts_ndc, radiance, faces, height,
                                         width, pad_rows)


def pack_render_records_reference(verts_ndc, radiance, faces, height: int,
                                  width: int, pad_rows: int):
    """Plain PyTorch version of pack_render_records, on any device and
    differentiable: _render_fields + _stack24."""
    return _stack24(_render_fields(verts_ndc, radiance, faces, height,
                                   width), pad_rows)


def pack_texture_records(verts_ndc, normals, flame, height: int, width: int,
                         pad_rows: int):
    """DECA's per-face render attributes, field-major (B, 24, pad_rows)
    f32: [world-normal corners 9 (corner-major) | affine forms 6 | anchor
    x0, y0 | UV corners 6 (grid_sample coordinates, corner-major) | zero
    1] over the raster rows: the record kernel with the UV rows as its
    tail where it takes them, else the plain version."""
    if _records_kernel_takes(verts_ndc, normals):
        return pack_records(verts_ndc, normals, flame.raster_rows, height,
                            width, pad_rows, tail=flame.raster_uv)
    return pack_texture_records_reference(verts_ndc, normals, flame, height,
                                          width, pad_rows)


def pack_texture_records_reference(verts_ndc, normals, flame, height: int,
                                   width: int, pad_rows: int):
    """Plain PyTorch version of pack_texture_records, on any device:
    _render_fields with the normals in the radiance's place, then the
    static UV rows."""
    rec = _stack24(_render_fields(verts_ndc, normals, flame.raster_rows,
                                  height, width), pad_rows)
    rec[:, 17:23, :flame.raster_uv.shape[1]] = flame.raster_uv
    return rec


def _shade_from_sel(tri_id, sel, height: int, width: int):
    """Color, barycentrics and skin mask from the select's winner fields
    sel (B, 20, H, W), with differentiable ops (twin of the reference's
    _shade_from_sel): the barycentrics evaluate the winner's anchored
    affine forms, so the forward equals the rasterizer's bary exactly and
    dL/dV_xy flows through the affine coefficients; dL/dradiance flows
    through the radiance fields. The skin corners (fields 17..19) are
    static, so the skin mask's gradient flows through the barycentrics
    only. Float ops and order as the kernel K1's shading.

    Returns (color (B,H,W,3), bary (B,H,W,3), skin (B,H,W)), zero on
    background."""
    dev = sel.device
    px = (torch.arange(width, device=dev, dtype=torch.float32) + 0.5)[None,
                                                                       None]
    py = (torch.arange(height, device=dev, dtype=torch.float32)
          + 0.5)[None, :, None]

    def f(k):
        return sel[:, k]

    qx = px - f(15)
    qy = py - f(16)
    w0 = f(9) * qx + f(10) * qy + f(11)
    w1 = f(12) * qx + f(13) * qy + f(14)
    w2 = 1.0 - w0 - w1
    hit = tri_id >= 0
    color = torch.stack([torch.where(hit, w0 * f(c) + w1 * f(c + 3)
                                     + w2 * f(c + 6), 0.0)
                         for c in range(3)], dim=-1)
    bary = torch.stack([torch.where(hit, v, 0.0) for v in (w0, w1, w2)],
                       dim=-1)
    sk = [f(17 + k).detach() for k in range(3)]
    skin = torch.where(hit, w0 * sk[0] + w1 * sk[1] + w2 * sk[2], 0.0)
    return color, bary, skin


class RenderOut(NamedTuple):
    image: torch.Tensor       # (B,H,W,3) composited render
    mask: torch.Tensor        # (B,H,W) coverage (1 = face)
    tri_id: torch.Tensor      # (B,H,W) int32
    bary: torch.Tensor        # (B,H,W,3) barycentrics
    radiance: torch.Tensor    # (B,N,3) per-vertex shaded color
    geometry: Geometry        # ops/flame.FLAMEGeometry on the FLAME path
    skin: Optional[torch.Tensor] = None  # (B,H,W) interpolated skin mask
                                         # (training path only)
    uv_detail_normals: Optional[torch.Tensor] = None  # (B,S,S,3) and
    displacement_map: Optional[torch.Tensor] = None   # (B,S,S): DECA's
                                         # detail model only


def render_geometry(geom: Geometry, gamma, bfm: DeviceBFM,
                    cfg: FaceReconConfig,
                    background: Optional[torch.Tensor] = None,
                    image_size: Optional[int] = None,
                    inference: bool = False) -> RenderOut:
    """Light (unless the geometry carries its radiance), pack the
    records, rasterize and composite. `geom.radiance`, where the
    forward-only path set it, is taken as the SH shade of `geom`'s texture
    and normals under `gamma`; it is recomputed where autograd records any
    of them."""
    h = w = image_size or cfg.image_size
    radiance = geom.radiance
    if radiance is None or autograd_records(geom.texture, geom.normals,
                                            gamma):
        with span("fr.geometry"):
            radiance = sh_ops.illuminate(geom.texture, geom.normals, gamma)
    pad_rows = rasterize.padded_rows(bfm.raster_rows.shape[0])
    kw = dict(height=h, width=w, tile_h=cfg.tile_h, n_cols=cfg.raster_cols,
              row_faces=bfm.raster_rows, row_id=bfm.raster_row_id)
    skin = None
    if inference:
        with span("fr.records"):
            records = pack_render_records(geom.verts_ndc, radiance,
                                          bfm.raster_rows, h, w, pad_rows)
        tri_id, color, bary = rasterize.rasterize_shaded(
            records, geom.verts_ndc, bfm.faces, **kw)
    else:
        with span("fr.records"):
            fields = _render_fields(geom.verts_ndc, radiance,
                                    bfm.raster_rows, h, w,
                                    corner_adj=bfm.raster_corner_adj)
            records = _stack24(fields, pad_rows, skin=bfm.raster_skin)
        tri_id, _, sel = rasterize.rasterize_select(
            records, geom.verts_ndc, bfm.faces, **kw)
        color, bary, skin = _shade_from_sel(tri_id, sel, h, w)
    mask = (tri_id >= 0).to(torch.float32)
    if background is None:
        background = torch.zeros_like(color)
    image = color * mask[..., None] + background * (1.0 - mask[..., None])
    return RenderOut(image=image, mask=mask, tri_id=tri_id, bary=bary,
                     radiance=radiance, geometry=geom, skin=skin)


def render_flame(codes, flame, cfg: FaceReconConfig,
                 background: Optional[torch.Tensor] = None,
                 image_size: Optional[int] = None) -> RenderOut:
    """DECA's coarse render: FLAME geometry (fr.flame), the albedo decode
    (fr.albedo), the textured records (fr.records), then binning and the
    textured raster; the image is albedo x SH shading over the face,
    composited over `background` (zeros by default, as DECA's). On the
    card the geometry replays a CUDA graph (ops/flame.graphed; the
    geometry returned is copied out of it), and the records are one
    launch of the record kernel.

    A detail config renders DECA's detailed image instead: after the
    albedo, the decoder's displacement map (fr.decoder) and the UV
    detail pass (fr.uv_detail: the shaded uv_texture, the detail normals
    and the displacement map), then the records, the binning and the
    fetch of uv_texture at each pixel's UV; the RenderOut also holds
    uv_detail_normals and displacement_map."""
    h = w = image_size or cfg.image_size
    pad_rows = rasterize.padded_rows(flame.raster_rows.shape[0])
    detail = cfg.n_detail > 0
    if detail and (flame.detail is None or codes.detail is None):
        raise ValueError("a detail config needs detail codes and a pack "
                         "with the detail model (device_flame(..., "
                         "decoder=...))")
    light = codes.light.reshape(-1, 9, 3).contiguous()
    normals_uv = disp = None

    def geometry_fn(shape, exp, pose, cam):
        return flame_ops.flame_geometry(
            codes._replace(shape=shape, exp=exp, pose=pose, cam=cam), flame,
            cfg, image_size=h)

    with torch.no_grad():
        with span("fr.flame"):
            geom = flame_ops.graphed(f"geometry{h}", geometry_fn, flame,
                                     codes.shape, codes.exp, codes.pose,
                                     codes.cam)
            if geom.verts_ndc.is_cuda:
                geom = geom._make(t.clone() for t in geom)
        with span("fr.albedo"):
            albedo = flame_ops.decode_albedo(codes.tex, flame)
        if detail:
            s = flame.detail.uv_size
            with span("fr.decoder"):
                uv_z = flame.detail.decoder(decoder_input(codes)).view(
                    -1, s, s)
            with span("fr.uv_detail"):
                texture, normals_uv, disp = uv_detail(
                    geom.verts_world, geom.normals, uv_z, flame.detail,
                    albedo, light, flame.sh_factor)
        with span("fr.records"):
            records = pack_texture_records(geom.verts_ndc, geom.normals,
                                           flame, h, w, pad_rows)
        kw = dict(height=h, width=w, tile_h=cfg.tile_h,
                  n_cols=cfg.raster_cols, row_faces=flame.raster_rows,
                  row_id=flame.raster_row_id)
        if detail:
            tri_id, color, bary = rasterize.rasterize_texfetch(
                records, texture, geom.verts_ndc, flame.faces, **kw)
        else:
            tri_id, color, bary = rasterize.rasterize_textured(
                records, albedo, light, flame.sh_factor, geom.verts_ndc,
                flame.faces, **kw)
    mask = (tri_id >= 0).to(torch.float32)
    image = color * mask[..., None]
    if background is not None:
        image = image + background * (1.0 - mask[..., None])
    return RenderOut(image=image, mask=mask, tri_id=tri_id, bary=bary,
                     radiance=None, geometry=geom,
                     uv_detail_normals=normals_uv, displacement_map=disp)


class AvatarGeometry(NamedTuple):
    """What the avatar's render keeps of its geometry and splats."""
    verts_world: torch.Tensor   # (B, N, 3) posed FLAME vertices
    means: torch.Tensor         # (B, G, 3) the Gaussians' world means
    xy: torch.Tensor            # (B, G, 2) their pixels (0 where culled)
    radius: torch.Tensor        # (B, G) int32 their radii (0 where culled)
    pairs: int                  # Gaussian-tile pairs of the microbatch


def render_avatar(codes, avatar, cfg: FaceReconConfig,
                  background=None) -> RenderOut:
    """GaussianAvatars' render of B frames (AvatarCodes): FLAME (fr.flame;
    replayed from a CUDA graph on the card, its vertices copied out), the
    preprocess (fr.gaussians), the prefix sum of the pair counts, its
    total read to the host once, the emit, the stable sort and the tile
    ranges (fr.splat_sort), and the blend (fr.splat), over `background`
    (3 floats; black by default). The RenderOut holds the image, the
    alpha as its mask, and an AvatarGeometry (with the host's pair count);
    tri_id and bary are None."""
    h, w = cfg.render_hw
    bsz = codes.shape.shape[0]
    tiles_x, tiles_y = gavatar_ops.tile_grid(h, w)
    bg = (0.0, 0.0, 0.0) if background is None else background
    with torch.no_grad():
        with span("fr.flame"):
            verts = flame_ops.graphed(
                "avatar", lambda *c: (gavatar_ops.posed_vertices(
                    *c, avatar),), avatar, codes.shape, codes.exp,
                codes.pose, codes.trans)[0]
            if verts.is_cuda:
                verts = verts.clone()
        with span("fr.gaussians"):
            splats = gavatar_ops.preprocess(
                verts, gavatar_ops.cameras(codes.view, codes.focal), avatar,
                h, w)
        with span("fr.splat_sort"):
            offsets = torch.cumsum(splats.count.reshape(-1), 0)
            pairs = int(offsets[-1]) if offsets.numel() else 0
            keys, ids = gavatar_ops.emit_pairs(splats, offsets, pairs, h, w)
            skeys, order = gavatar_ops.sort_pairs(keys)
            ranges, sids = gavatar_ops.tile_ranges(
                skeys, order, ids, bsz * tiles_x * tiles_y)
        with span("fr.splat"):
            image, alpha = gavatar_ops.blend(ranges, sids, splats.rec, h, w,
                                             bg)
    geom = AvatarGeometry(verts_world=verts, means=splats.means,
                          xy=splats.rec[..., :2], radius=splats.radius,
                          pairs=pairs)
    return RenderOut(image=image, mask=alpha, tri_id=None, bary=None,
                     radiance=None, geometry=geom)


def render_coeffs(coeffs: Coeffs, assets: DeviceBFM, cfg: FaceReconConfig,
                  background: Optional[torch.Tensor] = None,
                  image_size: Optional[int] = None,
                  inference: bool = False) -> RenderOut:
    """Coefficients -> composited image. inference=True takes the
    forward-only in-kernel-shaded path (K1); the default is the
    differentiable training render (K2 forward, K3 backward). A FLAME
    config (with DECA's codes and ops/flame.DeviceFLAME assets) renders
    DECA's coarse model (render_flame), which has no training render
    yet; a GaussianAvatars config (AvatarCodes, an ops/gavatar.DeviceAvatar,
    `background` 3 floats) splats the avatar (render_avatar), inference
    only too."""
    if is_gavatar(cfg):
        if not inference:
            raise ValueError("render_coeffs: GaussianAvatars renders for "
                             "inference only (inference=True)")
        with span("fr.render"):
            return render_avatar(coeffs, assets, cfg, background=background)
    if is_flame(cfg):
        if not inference:
            raise ValueError(
                "render_coeffs: DECA/FLAME renders for inference only "
                "(inference=True); its differentiable render (textured K2/K3 "
                "variants) is not implemented")
        with span("fr.render"):
            return render_flame(coeffs, assets, cfg, background=background,
                                image_size=image_size)
    with span("fr.render"):
        with span("fr.geometry"):
            geom = coeffs_to_geometry(coeffs, assets, cfg)
        return render_geometry(geom, coeffs.gamma, assets, cfg,
                               background=background, image_size=image_size,
                               inference=inference)
