"""DECA's detail model in UV space (Feng et al., arXiv:2012.04012;
decalib/deca.py `decode` and `displacement2normal`, utils/renderer.py
`world2uv` and `add_SHlight`, utils/util.py `vertex_normals` over
`generate_triangles`' dense grid). No twin in the JAX package.

From the posed world vertices and coarse normals of FLAME's geometry,
the decoder's uv_z (B, S, S), the decoded albedo (B, S, S, 3) and the
light (B, 9, 3), `uv_detail` gives
  - uv_texture (B, S, S, 3): albedo x SH-9 shading of the detail normal,
    the texture the detailed image is fetched from;
  - uv_detail_normals (B, S, S, 3): the dense grid's vertex normals of
    the displaced positions P = V_uv + (uv_z M) N_uv + fixed N_uv inside
    the mask M, the coarse normals N_uv outside it (DECA returns them
    (B, 3, S, S));
  - displacement_map (B, S, S): uv_z + fixed (uv_z unmasked, as DECA's
    decode returns it).
V_uv and N_uv are world2uv of the vertices and normals through the
static texel table (utils/flame.uv_texel_table), not renormalised. On
CUDA tensors one launch of `csrc/uv_detail.cu` computes all of it; on
CPU tensors the plain version `uv_detail_reference` does, with the
kernel's float ops in its order. DECA's dense grid (util.
generate_triangles with margins 2 and 5) is regular, so both take it as
a stencil: the cells that have faces (`dense_cells`) and the six faces
around a texel. `DeviceDetail` is the detail pack on the device, with
the folded decoder (models/deca_detail).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from facerecon_tpu_torch.models.deca_detail import (DetailGenerator,
                                                    FusedDetailGenerator)
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.utils.flame import DENSE_MARGINS


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceDetail:
    """utils/flame.DetailAssets on one device, with the FLAME faces as
    int32 (the kernel's) and the folded decoder."""
    fixed_uv_dis: torch.Tensor   # (S, S)
    eye_mask: torch.Tensor       # (S, S) uv_face_eye_mask
    texel_face: torch.Tensor     # (S * S,) int32, -1 = no face
    texel_bary: torch.Tensor     # (S * S, 3)
    faces: torch.Tensor          # (F, 3) int32 FLAME faces
    decoder: torch.nn.Module     # models/deca_detail.FusedDetailGenerator

    @property
    def uv_size(self) -> int:
        return self.fixed_uv_dis.shape[0]


def device_detail(detail, faces, decoder, dev) -> DeviceDetail:
    """Upload a DetailAssets pack with `decoder`, a DetailGenerator (DECA's
    D_detail), folded here."""
    if not isinstance(decoder, DetailGenerator):
        raise ValueError("the detail model's decoder is a DetailGenerator, "
                         f"not {type(decoder).__name__}")
    decoder = FusedDetailGenerator.fold(decoder.eval())
    if decoder.init_size * 32 != detail.uv_size:
        raise ValueError(f"the decoder makes {decoder.init_size * 32}^2 "
                         f"maps, the detail pack is {detail.uv_size}^2")

    def up(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)
    return DeviceDetail(
        fixed_uv_dis=up(detail.fixed_uv_dis),
        eye_mask=up(detail.uv_face_eye_mask),
        texel_face=up(detail.texel_face, torch.int32),
        texel_bary=up(detail.texel_bary),
        faces=up(faces, torch.int32),
        decoder=decoder.to(dev).eval())


def _check(verts, normals, uv_z, detail: DeviceDetail, albedo, light,
           sh_factor):
    bsz, n = verts.shape[:2]
    s = detail.uv_size
    _build.check_tensors(verts.device, {
        "verts": (verts, torch.float32, (bsz, n, 3)),
        "normals": (normals, torch.float32, (bsz, n, 3)),
        "uv_z": (uv_z, torch.float32, (bsz, s, s)),
        "albedo": (albedo, torch.float32, (bsz, s, s, 3)),
        "light": (light, torch.float32, (bsz, 9, 3)),
        "sh_factor": (sh_factor, torch.float32, (9,)),
        "fixed_uv_dis": (detail.fixed_uv_dis, torch.float32, (s, s)),
        "eye_mask": (detail.eye_mask, torch.float32, (s, s)),
        "texel_face": (detail.texel_face, torch.int32, (s * s,)),
        "texel_bary": (detail.texel_bary, torch.float32, (s * s, 3)),
        "faces": (detail.faces, torch.int32, (detail.faces.shape[0], 3)),
    })


def uv_detail(verts, normals, uv_z, detail: DeviceDetail, albedo, light,
              sh_factor):
    """(uv_texture (B, S, S, 3), uv_detail_normals (B, S, S, 3),
    displacement_map (B, S, S)) as the module docstring gives them. verts
    and normals (B, N, 3), uv_z (B, S, S), albedo (B, S, S, 3), light
    (B, 9, 3), sh_factor (9,), all float32 and contiguous on one device.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(verts, normals, uv_z, detail, albedo, light, sh_factor)
    if not _build.on_card(verts.device):
        return uv_detail_reference(verts, normals, uv_z, detail, albedo,
                                   light, sh_factor)
    bsz, n = verts.shape[:2]
    s = detail.uv_size
    texture = torch.empty_like(albedo)
    out_n = torch.empty_like(albedo)
    disp = torch.empty_like(uv_z)
    if bsz:
        _build.launch("uv_detail", verts.device,
                      (verts, normals, uv_z, detail.faces, detail.texel_face,
                       detail.texel_bary, detail.fixed_uv_dis,
                       detail.eye_mask, albedo, light, sh_factor, texture,
                       out_n, disp),
                      (bsz, n, s, *DENSE_MARGINS))
    return texture, out_n, disp


def _cross(a, b):
    """(..., 3) x (..., 3), DECA's cross product component by component."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def dense_cells(size: int) -> torch.Tensor:
    """(S, S) bool: the cells (y, x) of the dense grid that have faces
    (utils/flame.DENSE_MARGINS)."""
    mx, my = DENSE_MARGINS
    r = torch.arange(size)
    return (((r >= my) & (r < size - 1 - my))[:, None]
            & ((r >= mx) & (r < size - 1 - mx))[None, :])


def uv_detail_reference(verts, normals, uv_z, detail: DeviceDetail, albedo,
                        light, sh_factor):
    """Plain PyTorch version of the UV detail kernel on the same inputs,
    with its float ops in its order: world2uv by the table, the displaced
    positions, the six corner cross products of the dense faces around
    each texel in DECA's index_add_ order (zero where the cell has no
    faces), the normalisation, the blend, the SH shade and the albedo."""
    bsz = verts.shape[0]
    s = detail.uv_size
    dev = verts.device
    face = detail.texel_face.to(torch.int64)
    live = (face >= 0)[:, None]
    vid = detail.faces.to(torch.int64)[face.clamp(min=0)]      # (T, 3)
    w = detail.texel_bary

    def world2uv(a):                                           # (B, T, 3)
        c = a[:, vid]                                          # (B,T,3,3)
        out = (w[:, 0, None] * c[:, :, 0] + w[:, 1, None] * c[:, :, 1]
               + w[:, 2, None] * c[:, :, 2])
        return torch.where(live, out, 0.0).view(bsz, s, s, 3)
    v_uv, n_uv = world2uv(verts), world2uv(normals)
    m = detail.eye_mask
    z = (uv_z * m)[..., None]
    fixed = detail.fixed_uv_dis[..., None]
    p = (v_uv + z * n_uv) + fixed * n_uv
    pp = torch.nn.functional.pad(p, (0, 0, 1, 1, 1, 1))
    cells = torch.nn.functional.pad(dense_cells(s).to(dev), (1, 1, 1, 1))

    def at(dy, dx):
        return pp[:, 1 + dy:1 + dy + s, 1 + dx:1 + dx + s]

    def cell(dy, dx):
        return cells[1 + dy:1 + dy + s, 1 + dx:1 + dx + s, None]
    acc = torch.zeros_like(p)
    for valid, e0, e1 in (
            (cell(-1, 0), at(-1, 1), at(-1, 0)),
            (cell(-1, 0), at(0, 1), at(-1, 1)),
            (cell(-1, -1), at(-1, 0), at(0, -1)),
            (cell(0, -1), at(0, -1), at(1, -1)),
            (cell(0, -1), at(1, -1), at(1, 0)),
            (cell(0, 0), at(1, 0), at(0, 1))):
        acc = acc + torch.where(valid, _cross(e0 - p, e1 - p), 0.0)
    ax, ay, az = acc.unbind(-1)
    length = torch.clamp(torch.sqrt(ax * ax + ay * ay + az * az), min=1e-6)
    mm, keep = m[..., None], (1.0 - m)[..., None]
    nd = (acc / length[..., None]) * mm + n_uv * keep
    nx, ny, nz = nd.unbind(-1)
    basis = (torch.ones_like(nx), nx, ny, nz, nx * ny, nx * nz, ny * nz,
             nx * nx - ny * ny, 3.0 * (nz * nz) - 1.0)
    shading = []
    for c in range(3):
        lc = light[:, :, c, None, None]
        acc_s = (basis[0] * sh_factor[0]) * lc[:, 0]
        for k in range(1, 9):
            acc_s = acc_s + (basis[k] * sh_factor[k]) * lc[:, k]
        shading.append(acc_s)
    texture = albedo * torch.stack(shading, -1)
    return texture, nd, uv_z + detail.fixed_uv_dis
