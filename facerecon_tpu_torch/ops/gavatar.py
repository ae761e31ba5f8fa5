"""GaussianAvatars in the port (Qian et al., "GaussianAvatars:
Photorealistic Head Avatars with Rigged 3D Gaussians", CVPR 2024,
arXiv:2312.02069; github.com/ShenhanQian/GaussianAvatars) and the
forward pass of 3D Gaussian Splatting it ships (Kerbl et al., SIGGRAPH
2023, the diff-gaussian-rasterization package). No twin in the JAX
package: this is the port's first renderer that does not rasterize
triangles.

A frame (utils/coeffs.AvatarCodes) poses FLAME with the full 15-number
pose and a translation (`posed_vertices`: ops/flame.lbs, then + trans),
binds each Gaussian to its triangle's frame and splats them into an
H x W image through four steps, each a kernel of csrc/gaussians.cu on
CUDA tensors and its plain version (`*_reference`, the kernel's float
ops in its order) on CPU tensors:

  preprocess   the triangle frames, the binding to world, the 3D
               covariance, the EWA projection (clamped, +0.3 on the 2D
               diagonal), the conic, SH-3, the radius and the tile
               rectangle of every (frame, Gaussian): `Splats`;
  emit_pairs   one (tile, depth) key and the Gaussian's id for every tile
               a Gaussian touches, at the offsets of the counts' prefix
               sum;
  tile_ranges  after a stable sort of the keys (`sort_pairs`, torch.sort,
               CUB's radix sort on the card), each (frame, tile)'s range
               of the sorted list and the ids in that order;
  blend        each pixel blends its tile's list front to back.

The rules are csrc/gaussians.cu's header's. Everything is float32 with
TF32 off; nothing here records a gradient. `DeviceAvatar` is the asset
pack on the device: FLAME's skinning arrays (the names ops/flame.lbs
reads), the faces as int32, and the Gaussians' 59 parameters in two
blocks, `params` (G, 11) [xyz | rotation (w, x, y, z) | scaling |
opacity] and `sh` (G, 48) (16 coefficients x RGB, coefficient-major).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from facerecon_tpu_torch import resolve_device
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops.flame import lbs

TILE = 16
NEAR = 0.2
DILATION = 0.3
CLAMP = 1.3
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
N_SH = 16
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceAvatar:
    """utils/gavatar.AvatarAssets on one device, and the CUDA graph of its
    FLAME (ops/flame.graphed) under `graphs`."""
    v_template: torch.Tensor      # (N, 3)
    shapedirs: torch.Tensor       # (3N, n_shape + n_exp)
    posedirs: torch.Tensor        # (36, 3N)
    J_regressor: torch.Tensor     # (5, N)
    lbs_weights: torch.Tensor     # (N, 5)
    faces: torch.Tensor           # (F, 3) int32
    binding: torch.Tensor         # (G,) int32
    params: torch.Tensor          # (G, 11)
    sh: torch.Tensor              # (G, 48)
    parents: tuple                # (5,) python ints
    graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    @property
    def n_gaussians(self) -> int:
        return self.binding.shape[0]


def device_avatar(assets, device="cuda") -> DeviceAvatar:
    """Upload an AvatarAssets pack once."""
    dev = resolve_device(device)
    n = assets.n_vertices

    def up(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)
    g = assets.n_gaussians
    params = np.concatenate([assets.xyz, assets.rotation, assets.scaling,
                             np.asarray(assets.opacity).reshape(g, 1)], 1)
    sh = np.concatenate([assets.features_dc, assets.features_rest],
                        1).reshape(g, N_SH * 3)
    return DeviceAvatar(
        v_template=up(assets.v_template),
        shapedirs=up(np.asarray(assets.shapedirs).reshape(3 * n, -1)),
        posedirs=up(assets.posedirs),
        J_regressor=up(assets.J_regressor),
        lbs_weights=up(assets.lbs_weights),
        faces=up(assets.faces, torch.int32),
        binding=up(assets.binding, torch.int32),
        params=up(params), sh=up(sh),
        parents=tuple(int(p) for p in assets.parents))


def posed_vertices(shape, exp, pose, trans, avatar: DeviceAvatar):
    """(B, N, 3): FLAME's blendshapes, correctives and skinning under the
    full pose (B, 15), then the translation (B, 3) (GaussianAvatars'
    FLAME adds it after the skinning)."""
    verts, _ = lbs(torch.cat([shape, exp], dim=1), pose, avatar)
    return verts + trans[:, None, :]


class Splats(NamedTuple):
    """What the preprocess gives every (frame, Gaussian)."""
    means: torch.Tensor    # (B, G, 3) world means
    rec: torch.Tensor      # (B, G, 9) [x, y | conic a, b, c | opacity |
                           # r, g, b]: the blend's record, 0 where culled
    depth: torch.Tensor    # (B, G) view z, 0 where culled
    radius: torch.Tensor   # (B, G) int32 pixels, 0 where culled
    count: torch.Tensor    # (B, G) int32 tiles touched, 0 where culled


def tile_grid(height: int, width: int):
    """(tiles along x, tiles along y) of 16 x 16 pixels."""
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def tile_rect(x, y, r, tiles_x: int, tiles_y: int):
    """3DGS's getRect: the tiles [x0, x1) x [y0, y1) a Gaussian at pixel
    (x, y) of radius r (int) touches, each (...) int32, as the kernels
    compute it: C's truncation of ((x - r) / 16) and of (((x + r) + 16) -
    1) / 16, clamped to the grid. x, y, r finite."""
    rf = r.to(torch.float32)

    def cut(v, top):
        return torch.trunc(v / TILE).to(torch.int32).clamp(0, top)
    return (cut(x - rf, tiles_x), cut(y - rf, tiles_y),
            cut(((x + rf) + TILE) - 1.0, tiles_x),
            cut(((y + rf) + TILE) - 1.0, tiles_y))


def cameras(view, focal) -> torch.Tensor:
    """(B, 14) [world-to-camera 3 x 4 | fx | fy], contiguous."""
    return torch.cat([view, focal], dim=1).contiguous()


def _check_prep(verts, cams, avatar, height, width):
    bsz, n = verts.shape[:2]
    g = avatar.n_gaussians
    _build.check_tensors(verts.device, {
        "verts": (verts, torch.float32, (bsz, n, 3)),
        "cams": (cams, torch.float32, (bsz, 14)),
        "faces": (avatar.faces, torch.int32, (avatar.faces.shape[0], 3)),
        "binding": (avatar.binding, torch.int32, (g,)),
        "params": (avatar.params, torch.float32, (g, 11)),
        "sh": (avatar.sh, torch.float32, (g, N_SH * 3))})
    if height < 1 or width < 1:
        raise ValueError(f"an image of {height} x {width}")


def preprocess(verts, cams, avatar: DeviceAvatar, height: int,
               width: int) -> Splats:
    """Splats of every (frame, Gaussian): verts (B, N, 3) posed FLAME
    vertices, cams (B, 14) (`cameras`). CUDA tensors launch gauss_prep
    once (one thread a Gaussian over the B frames); CPU tensors take the
    plain version."""
    _check_prep(verts, cams, avatar, height, width)
    if not _build.on_card(verts.device):
        return preprocess_reference(verts, cams, avatar, height, width)
    bsz, n = verts.shape[:2]
    g = avatar.n_gaussians
    f32 = dict(dtype=torch.float32, device=verts.device)
    i32 = dict(dtype=torch.int32, device=verts.device)
    out = Splats(means=torch.empty((bsz, g, 3), **f32),
                 rec=torch.empty((bsz, g, 9), **f32),
                 depth=torch.empty((bsz, g), **f32),
                 radius=torch.empty((bsz, g), **i32),
                 count=torch.empty((bsz, g), **i32))
    if bsz and g:
        _build.launch("gauss_prep", verts.device,
                      (verts, avatar.faces, avatar.binding, avatar.params,
                       avatar.sh, cams, *out),
                      (bsz, n, g, height, width))
    return out


# --- the plain versions: the kernels' float ops in their order ---

def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _unit(a):
    n = torch.sqrt(torch.clamp(_dot(a, a), min=1e-20))
    return tuple(c / n for c in a)


def _sh_weights(d):
    """The 16 SH-3 basis values times their constants, as the kernel
    forms them: d a unit direction (3 tensors)."""
    x, y, z = d
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return (torch.full_like(x, SH_C0), -(SH_C1 * y), SH_C1 * z,
            -(SH_C1 * x), SH_C2[0] * xy, SH_C2[1] * yz,
            SH_C2[2] * ((2.0 * zz - xx) - yy), SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
            (SH_C3[0] * y) * (3.0 * xx - yy), (SH_C3[1] * xy) * z,
            (SH_C3[2] * y) * ((4.0 * zz - xx) - yy),
            (SH_C3[3] * z) * ((2.0 * zz - 3.0 * xx) - 3.0 * yy),
            (SH_C3[4] * x) * ((4.0 * zz - xx) - yy),
            (SH_C3[5] * z) * (xx - yy), (SH_C3[6] * x) * (xx - 3.0 * yy))


def face_frames(v0, v1, v2):
    """The frame of each triangle (3-tuples of tensors): its rotation's
    columns (a0, a1, a2), its scale k and its origin T, as the kernel
    computes them (GaussianAvatars' compute_face_orientation)."""
    e1 = tuple(a - b for a, b in zip(v1, v0))
    e2 = tuple(a - b for a, b in zip(v2, v0))
    a0 = _unit(e1)
    a1 = _unit(_cross(a0, e2))
    a2 = tuple(-c for c in _unit(_cross(a1, a0)))
    k = (torch.sqrt(torch.clamp(_dot(e1, e1), min=1e-20))
         + torch.abs(_dot(a2, e2))) * 0.5
    t = tuple(((a + b) + c) * (1.0 / 3.0) for a, b, c in zip(v0, v1, v2))
    return (a0, a1, a2), k, t


def preprocess_reference(verts, cams, avatar: DeviceAvatar, height: int,
                         width: int) -> Splats:
    """Plain PyTorch version of the preprocess kernel, vectorised over
    (frame, Gaussian), with its float ops in its order."""
    bsz = verts.shape[0]
    g = avatar.n_gaussians
    p = avatar.params
    mu = p[:, 0], p[:, 1], p[:, 2]
    q = p[:, 3], p[:, 4], p[:, 5], p[:, 6]
    qn = torch.clamp(torch.sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2])
                                + q[3] * q[3]), min=1e-12)
    qr, qx, qy, qz = (c / qn for c in q)
    rq = ((1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qr * qz),
           2.0 * (qx * qz + qr * qy)),
          (2.0 * (qx * qy + qr * qz), 1.0 - 2.0 * (qx * qx + qz * qz),
           2.0 * (qy * qz - qr * qx)),
          (2.0 * (qx * qz - qr * qy), 2.0 * (qy * qz + qr * qx),
           1.0 - 2.0 * (qx * qx + qy * qy)))
    es = torch.exp(p[:, 7]), torch.exp(p[:, 8]), torch.exp(p[:, 9])
    opac = 1.0 / (1.0 + torch.exp(-p[:, 10]))
    corners = avatar.faces.to(torch.int64)[avatar.binding.to(torch.int64)]
    v = [tuple(verts[:, corners[:, c], i] for i in range(3))
         for c in range(3)]                                 # (B, G) each
    (a0, a1, a2), k, t = face_frames(*v)
    m = tuple(((a0[i] * mu[0] + a1[i] * mu[1]) + a2[i] * mu[2]) * k + t[i]
              for i in range(3))
    cam = [cams[:, j, None] for j in range(14)]             # (B, 1) each
    pv = tuple(((cam[4 * i] * m[0] + cam[4 * i + 1] * m[1])
                + cam[4 * i + 2] * m[2]) + cam[4 * i + 3] for i in range(3))
    cols = (a0, a1, a2)
    mm = [[(es[j] * k) * ((cols[0][i] * rq[0][j] + cols[1][i] * rq[1][j])
                          + cols[2][i] * rq[2][j]) for j in range(3)]
          for i in range(3)]
    sg = [[(mm[i][0] * mm[j][0] + mm[i][1] * mm[j][1]) + mm[i][2] * mm[j][2]
           for j in range(3)] for i in range(3)]
    fx, fy = cam[12], cam[13]
    # a true division, as the kernel's (PyTorch divides a scalar by a
    # tensor through its reciprocal)
    wide, high = torch.full_like(fx, float(width)), torch.full_like(
        fy, float(height))
    tanx, tany = wide / (2.0 * fx), high / (2.0 * fy)
    focx, focy = wide / (2.0 * tanx), high / (2.0 * tany)
    limx, limy = CLAMP * tanx, CLAMP * tany
    tx = torch.minimum(limx, torch.maximum(-limx, pv[0] / pv[2])) * pv[2]
    ty = torch.minimum(limy, torch.maximum(-limy, pv[1] / pv[2])) * pv[2]
    zz = pv[2] * pv[2]
    j00, j02 = focx / pv[2], -((focx * tx) / zz)
    j11, j12 = focy / pv[2], -((focy * ty) / zz)
    tm = ([j00 * cam[j] + j02 * cam[8 + j] for j in range(3)],
          [j11 * cam[4 + j] + j12 * cam[8 + j] for j in range(3)])
    u = [[(tm[i][0] * sg[0][j] + tm[i][1] * sg[1][j]) + tm[i][2] * sg[2][j]
          for j in range(3)] for i in range(2)]

    def quad(a, b):
        return (u[a][0] * tm[b][0] + u[a][1] * tm[b][1]) + u[a][2] * tm[b][2]
    c00 = quad(0, 0) + DILATION
    c01 = quad(0, 1)
    c11 = quad(1, 1) + DILATION
    det = c00 * c11 - c01 * c01
    front = pv[2] > NEAR
    ok = front & (det != 0.0)
    inv = 1.0 / det
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    r = torch.where(ok, torch.ceil(3.0 * torch.sqrt(lam)), 0.0).to(
        torch.int32)
    zw = pv[2] + 1e-7
    x = (((pv[0] / tanx) / zw + 1.0) * float(width) - 1.0) * 0.5
    y = (((pv[1] / tany) / zw + 1.0) * float(height) - 1.0) * 0.5
    x, y = torch.where(ok, x, 0.0), torch.where(ok, y, 0.0)
    x0, y0, x1, y1 = tile_rect(x, y, r, *tile_grid(height, width))
    n = torch.where(ok, (x1 - x0) * (y1 - y0), 0)
    live = n > 0
    cp = tuple(-((cam[i] * cam[3] + cam[4 + i] * cam[7])
                 + cam[8 + i] * cam[11]) for i in range(3))
    d = tuple(a - b for a, b in zip(m, cp))
    dl = torch.sqrt(_dot(d, d))
    w = _sh_weights(tuple(c / dl for c in d))
    sh = avatar.sh
    col = []
    for ch in range(3):
        acc = w[0] * sh[:, ch]
        for i in range(1, N_SH):
            acc = acc + w[i] * sh[:, i * 3 + ch]
        col.append(torch.clamp(acc + 0.5, min=0.0))
    rec = torch.stack([x, y, c11 * inv, -c01 * inv, c00 * inv,
                       opac.expand(bsz, g), *col], -1)
    return Splats(means=torch.stack(m, -1),
                  rec=torch.where(live[..., None], rec, 0.0),
                  depth=torch.where(live, pv[2], 0.0),
                  radius=torch.where(live, r, 0),
                  count=n.to(torch.int32))


def emit_pairs(splats: Splats, offsets, n_pairs: int, height: int,
               width: int):
    """(keys (P,) int64, ids (P,) int32): for every (frame b, Gaussian g)
    in order, the tiles its rectangle touches, row by row, each as the
    key ((b tiles + tile) << 32 | the depth's float bits) and g, from
    position offsets[b G + g] - count; offsets is the inclusive prefix
    sum of splats.count (B G,) int64 and n_pairs its last value. CUDA
    tensors launch gauss_emit once; CPU tensors take the plain version."""
    bsz, g = splats.depth.shape
    dev = splats.depth.device
    _build.check_tensors(dev, {"rec": (splats.rec, torch.float32, (bsz, g, 9)),
                 "depth": (splats.depth, torch.float32, (bsz, g)),
                 "radius": (splats.radius, torch.int32, (bsz, g)),
                 "count": (splats.count, torch.int32, (bsz, g)),
                 "offsets": (offsets, torch.int64, (bsz * g,))})
    tiles_x, tiles_y = tile_grid(height, width)
    if bsz * tiles_x * tiles_y >= 1 << 31 or n_pairs >= 1 << 31:
        raise ValueError(f"{bsz} frames of {tiles_x * tiles_y} tiles or "
                         f"{n_pairs} pairs: past the int32 index")
    if not _build.on_card(dev):
        return emit_pairs_reference(splats, offsets, n_pairs, height, width)
    keys = torch.empty(n_pairs, dtype=torch.int64, device=dev)
    ids = torch.empty(n_pairs, dtype=torch.int32, device=dev)
    if n_pairs:
        _build.launch("gauss_emit", dev,
                      (splats.rec, splats.depth, splats.radius, splats.count,
                       offsets, keys, ids), (bsz, g, height, width))
    return keys, ids


def emit_pairs_reference(splats: Splats, offsets, n_pairs: int, height: int,
                         width: int):
    """Plain PyTorch version of gauss_emit: the same keys and ids in the
    same places."""
    bsz, g = splats.depth.shape
    tiles_x, tiles_y = tile_grid(height, width)
    count = splats.count.reshape(-1).to(torch.int64)
    at = torch.nonzero(count > 0).squeeze(1)
    rec = splats.rec.reshape(-1, 9)[at]
    x0, y0, x1, _ = tile_rect(rec[:, 0], rec[:, 1],
                              splats.radius.reshape(-1)[at], tiles_x, tiles_y)
    n = count[at]
    entry = torch.repeat_interleave(torch.arange(len(at), device=at.device),
                                    n)
    local = torch.arange(int(n.sum()), device=at.device) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    wide = (x1 - x0).to(torch.int64)[entry]
    tile = ((y0.to(torch.int64)[entry] + local // wide) * tiles_x
            + x0.to(torch.int64)[entry] + local % wide)
    frame = at[entry] // g
    bits = splats.depth.reshape(-1)[at].view(torch.int32).to(
        torch.int64)[entry] & 0xFFFFFFFF
    keys = ((frame * (tiles_x * tiles_y) + tile) << 32) | bits
    if keys.numel() != n_pairs or (n_pairs and int(offsets[-1]) != n_pairs):
        raise ValueError(f"{keys.numel()} pairs, expected {n_pairs}")
    return keys, (at[entry] % g).to(torch.int32)


def sort_pairs(keys):
    """(sorted keys, the permutation): a stable sort, so pairs of equal
    key keep the emit order (within a frame, the lower Gaussian id
    first). The library's (CUB's radix sort on the card)."""
    return torch.sort(keys, stable=True)


def tile_ranges(skeys, order, ids, n_tiles: int):
    """(ranges (n_tiles, 2) int32 [start, end) of each (frame, tile) in
    the sorted list, 0 where empty; the ids in sorted order (P,) int32).
    CUDA tensors launch gauss_ranges once (after a zero fill); CPU
    tensors take the plain version."""
    n = skeys.shape[0]
    dev = skeys.device
    _build.check_tensors(dev, {"skeys": (skeys, torch.int64, (n,)),
                 "order": (order, torch.int64, (n,)),
                 "ids": (ids, torch.int32, (n,))})
    if not _build.on_card(dev):
        return tile_ranges_reference(skeys, order, ids, n_tiles)
    ranges = torch.zeros((n_tiles, 2), dtype=torch.int32, device=dev)
    sids = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _build.launch("gauss_ranges", dev, (skeys, order, ids, ranges, sids),
                      (n,))
    return ranges, sids


def tile_ranges_reference(skeys, order, ids, n_tiles: int):
    """Plain PyTorch version of gauss_ranges."""
    n = skeys.shape[0]
    tile = skeys >> 32
    ranges = torch.zeros((n_tiles, 2), dtype=torch.int32,
                         device=skeys.device)
    if n:
        pos = torch.arange(n, device=skeys.device)
        first = torch.ones(n, dtype=torch.bool, device=skeys.device)
        first[1:] = tile[1:] != tile[:-1]
        last = torch.ones_like(first)
        last[:-1] = first[1:]
        ranges[tile[first], 0] = pos[first].to(torch.int32)
        ranges[tile[last], 1] = (pos[last] + 1).to(torch.int32)
    return ranges, ids[order]


def blend(ranges, sids, rec, height: int, width: int, background):
    """(image (B, H, W, 3), alpha (B, H, W)): each pixel blends its tile's
    sorted list front to back (the header's rules), over the constant
    background (3 floats). CUDA tensors launch gauss_blend once (one block
    a frame and tile); CPU tensors take the plain version."""
    bsz, g = rec.shape[:2]
    tiles_x, tiles_y = tile_grid(height, width)
    dev = rec.device
    _build.check_tensors(dev, {"ranges": (ranges, torch.int32,
                            (bsz * tiles_x * tiles_y, 2)),
                 "sids": (sids, torch.int32, (sids.shape[0],)),
                 "rec": (rec, torch.float32, (bsz, g, 9))})
    bg = tuple(float(c) for c in background)
    if len(bg) != 3 or bsz > 65535:
        raise ValueError(f"a background of 3 values and at most 65535 "
                         f"frames, got {bg} and {bsz}")
    if not _build.on_card(dev):
        return blend_reference(ranges, sids, rec, height, width, bg)
    image = torch.empty((bsz, height, width, 3), dtype=torch.float32,
                        device=dev)
    alpha = torch.empty((bsz, height, width), dtype=torch.float32,
                        device=dev)
    if bsz:
        _build.launch("gauss_blend", dev, (ranges, sids, rec, image, alpha),
                      (bsz, g, height, width), floats=bg)
    return image, alpha


def blend_reference(ranges, sids, rec, height: int, width: int, background):
    """Plain PyTorch version of gauss_blend: list position by list
    position, every (frame, tile, pixel) at once, with the kernel's float
    ops in its order."""
    bsz, g = rec.shape[:2]
    tiles_x, tiles_y = tile_grid(height, width)
    dev = rec.device
    n_t = bsz * tiles_x * tiles_y
    tid = torch.arange(n_t, device=dev)
    lane = torch.arange(TILE * TILE, device=dev)
    px = ((tid % tiles_x) * TILE)[:, None] + lane % TILE        # (n_t, 256)
    py = (((tid // tiles_x) % tiles_y) * TILE)[:, None] + lane // TILE
    inside = (px < width) & (py < height)
    fx, fy = px.to(torch.float32), py.to(torch.float32)
    start = ranges[:, 0].to(torch.int64)
    length = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    base = (tid // (tiles_x * tiles_y)) * g
    flat = rec.reshape(-1, 9)
    t = torch.ones((n_t, TILE * TILE), device=dev)
    c = torch.zeros((n_t, TILE * TILE, 3), device=dev)
    done = ~inside
    steps = int(length.max()) if n_t else 0
    for j in range(steps):
        if j % 32 == 0 and bool(done.all()):
            break
        has = j < length
        k = torch.where(has, start + j, 0)
        q = flat[base + sids[k].to(torch.int64)]                 # (n_t, 9)
        dx = q[:, 0, None] - fx
        dy = q[:, 1, None] - fy
        power = (-0.5 * ((q[:, 2, None] * dx) * dx + (q[:, 4, None] * dy)
                         * dy)) - (q[:, 3, None] * dx) * dy
        a = torch.clamp(q[:, 5, None] * torch.exp(power), max=ALPHA_MAX)
        test = t * (1.0 - a)
        take = has[:, None] & ~done & ~(power > 0.0) & ~(a < ALPHA_MIN)
        stop = take & (test < T_MIN)
        take = take & ~stop
        c = torch.where(take[..., None], c + (q[:, None, 6:9] * a[..., None])
                        * t[..., None], c)
        t = torch.where(take, test, t)
        done = done | stop
    bg = torch.tensor(background, dtype=torch.float32, device=dev)
    image = c + t[..., None] * bg

    def to_frames(v, ch):
        v = v.reshape(bsz, tiles_y, tiles_x, TILE, TILE, ch).permute(
            0, 1, 3, 2, 4, 5).reshape(bsz, tiles_y * TILE, tiles_x * TILE,
                                      ch)
        return v[:, :height, :width]
    return to_frames(image, 3), to_frames(1.0 - t[..., None], 1)[..., 0]
