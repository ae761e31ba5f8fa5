"""DECA's coarse model on FLAME: geometry, landmarks and the albedo decode
(Feng et al., arXiv:2012.04012; decalib/models/FLAME.py, lbs.py,
utils/util.py and utils/renderer.py). No twin in the JAX package.

Everything is float32 with TF32 off (the pipeline sets it), batched over
a leading B axis, from DECA's codes (utils/coeffs.DECACodes):
  - blendshapes: v_shaped = template + shapedirs . [shape | exp];
  - the full pose [global | neck 0 | jaw | eyes 0] (15 numbers) through
    Rodrigues' formula with angle = |r + 1e-8| (so a zero rotation is the
    identity exactly);
  - pose correctives: (R_j - I) of joints 1-4 (36 numbers) . posedirs;
  - the kinematic chain over the 5 joints (parents [-1, 0, 1, 1, 1]),
    joints regressed from v_shaped, giving the transforms A, and linear
    blend skinning T = W . A, v = T . [v_posed, 1];
  - 68 landmarks, each a barycentric point of a face: 17 contour points
    from the (79, 17) table at the bin of the neck-then-root rotation's
    yaw (round(clamp(deg, max=39)); a negative yaw maps to 39 - yaw, or
    to 78 below -39), then the 51 static ones;
  - area-weighted vertex normals of the posed (world) mesh: the sum of
    the adjacent faces' cross products over max(|sum|, 1e-6), as DECA's
    F.normalize (`vertex_normals`: one gather of the vertices' faces
    through the fixed adjacency table and one sum, no scatter, so the
    order of the sum is the same on every run);
  - DECA's orthographic camera batch_orth_proj, s * (x + tx, y + ty, z),
    with y and z negated for the raster.
The raster's inputs (verts_ndc) are [s(x + tx), s(y + ty), -s z]:
ops/binning.ndc_to_screen puts pixel column i's centre at x = (2i + 1) /
W - 1 and row j's at s(y + ty) = 1 - (2j + 1) / H, as DECA's PyTorch3D
rasterizer samples them (its x and y flips included), and the lowest
depth -s z wins, ties to the lowest face id. Departures from DECA's
code: DECA adds 10 to that depth before rasterizing, inside its
rasterizer's near and far planes, which never clip at these scales;
without the offset the depths keep more bits. A pixel centre on a
triangle's edge counts as covered (PyTorch3D's test is strict).

The albedo (DECA's FLAMETex with the BFM-derived space): mean + basis .
tex over A x A x 3 texels (A = 512, BGR), nearest-downsampled to S x S
(S = 256) with F.interpolate, and the channels flipped to RGB.
`device_flame` keeps only the rows of the S x S texels the downsample
keeps (found by running F.interpolate on the texel indices), so
`decode_albedo` is that function with a quarter of the work. It returns
(B, S, S, 3), RGB last, the layout the texture kernel reads.

On the card the render replays FLAME's geometry from a CUDA graph
(`graphed`): it is over a hundred small launches a microbatch, whose
host cost would otherwise come near the device time of the whole render
(~5.6 ms for 256 faces at 224 px on an H100) and let the host set the
pace. The graph runs the same kernels on the same inputs, so the results
are the eager path's. The textured records are one launch of the record
kernel (ops/render.pack_records) and need no graph.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from facerecon_tpu_torch import resolve_device
from facerecon_tpu_torch.config import FaceReconConfig
from facerecon_tpu_torch.ops.binning import ndc_to_screen
from facerecon_tpu_torch.ops.detail import device_detail
from facerecon_tpu_torch.utils.coeffs import DECACodes

# DECA's SH constant_factor (utils/renderer.py), float64 cast to float32
_PI = np.pi
SH_FACTOR = np.array([
    1 / np.sqrt(4 * _PI),
    ((2 * _PI) / 3) * np.sqrt(3 / (4 * _PI)),
    ((2 * _PI) / 3) * np.sqrt(3 / (4 * _PI)),
    ((2 * _PI) / 3) * np.sqrt(3 / (4 * _PI)),
    (_PI / 4) * 3 * np.sqrt(5 / (12 * _PI)),
    (_PI / 4) * 3 * np.sqrt(5 / (12 * _PI)),
    (_PI / 4) * 3 * np.sqrt(5 / (12 * _PI)),
    (_PI / 4) * (3 / 2) * np.sqrt(5 / (12 * _PI)),
    (_PI / 4) * (1 / 2) * np.sqrt(5 / (4 * _PI)),
], dtype=np.float32)
NECK_KIN_CHAIN = (1, 0)     # neck, then root (FLAME's NECK_IDX = 1)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceFLAME:
    """FLAMEAssets mirrored as tensors on one device, with the albedo's
    kept texels and the raster rows' UVs, and the CUDA graphs the render
    captured on them (`graphed`), which go with the pack:
    dataclasses.replace gives a new pack with none."""
    v_template: torch.Tensor      # (N, 3)
    shapedirs: torch.Tensor       # (3N, n_shape + n_exp)
    posedirs: torch.Tensor        # (36, 3N)
    J_regressor: torch.Tensor     # (5, N)
    lbs_weights: torch.Tensor     # (N, 5)
    faces: torch.Tensor           # (F, 3) int64
    lmk_faces_idx: torch.Tensor   # (51,) int64
    lmk_bary_coords: torch.Tensor  # (51, 3)
    dynamic_lmk_faces_idx: torch.Tensor   # (79, 17) int64
    dynamic_lmk_bary_coords: torch.Tensor  # (79, 17, 3)
    albedo_mean: torch.Tensor     # (S * S * 3,) the kept texels, RGB
    albedo_basis: torch.Tensor    # (n_tex, S * S * 3)
    vertex_face_adj: torch.Tensor  # (N, deg_max) int64, F = pad
    raster_rows: torch.Tensor     # (F', 3) int64
    raster_row_id: torch.Tensor   # (F',) int64, F + 1 = pad
    raster_uv: torch.Tensor       # (6, F') grid_sample coordinates of
                                  # each row's corners [g0x g0y g1x g1y g2x
                                  # g2y]; zero on pad rows
    sh_factor: torch.Tensor       # (9,) SH_FACTOR
    parents: tuple                # (5,) python ints
    uv_size: int                  # S
    detail: object = None         # ops/detail.DeviceDetail: DECA's detail
                                  # model, where the pack has one
    graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)


def kept_texels(albedo_size: int, uv_size: int) -> np.ndarray:
    """(S, S) int64: the source texel (y * A + x) each texel of DECA's
    nearest downsample F.interpolate(., [S, S]) takes."""
    idx = torch.arange(albedo_size * albedo_size, dtype=torch.float64)
    out = F.interpolate(idx.view(1, 1, albedo_size, albedo_size),
                        [uv_size, uv_size])
    return out[0, 0].to(torch.int64).numpy()


def device_flame(assets, device="cuda", n_tex: int = 50,
                 uv_size: int = 256, decoder=None) -> DeviceFLAME:
    """Upload a FLAMEAssets pack once, keeping the albedo's first n_tex
    components at the texels of the uv_size downsample. A pack with
    detail assets and a `decoder` (a models/deca_detail.DetailGenerator,
    folded here) also carries DECA's detail model
    (ops/detail.DeviceDetail)."""
    dev = resolve_device(device)
    detail = None
    if decoder is not None:
        if assets.detail is None:
            raise ValueError("a decoder was given for a pack without "
                             "detail assets")
        if assets.detail.uv_size != uv_size:
            raise ValueError(f"detail maps of {assets.detail.uv_size}^2 "
                             f"for a {uv_size}^2 albedo")
        detail = device_detail(assets.detail, assets.faces, decoder, dev)
    n = assets.n_vertices
    src = kept_texels(assets.albedo_size, uv_size).reshape(-1)
    # texel (y, x) channel c (RGB) reads the source row of channel 2 - c
    rows = (src[:, None] * 3 + np.array([2, 1, 0])).reshape(-1)
    n_f = assets.n_faces
    rid = np.asarray(assets.raster_row_id, np.int64)

    def up(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)
    uv = up(assets.uvcoords) * 2 - 1          # DECA's uvcoords * 2 - 1,
    uv = torch.stack([uv[:, 0], -uv[:, 1]], 1)  # v negated
    live = torch.as_tensor(rid < n_f).to(dev)
    uvf = up(np.asarray(assets.uvfaces)[np.clip(rid, 0, n_f - 1)],
             torch.int64)                     # (F', 3)
    raster_uv = torch.where(live[None], uv[uvf].permute(1, 2, 0).reshape(
        6, -1), 0.0)
    return DeviceFLAME(
        v_template=up(assets.v_template),
        shapedirs=up(np.asarray(assets.shapedirs).reshape(3 * n, -1)),
        posedirs=up(assets.posedirs),
        J_regressor=up(assets.J_regressor),
        lbs_weights=up(assets.lbs_weights),
        faces=up(assets.faces, torch.int64),
        lmk_faces_idx=up(assets.lmk_faces_idx, torch.int64),
        lmk_bary_coords=up(assets.lmk_bary_coords),
        dynamic_lmk_faces_idx=up(assets.dynamic_lmk_faces_idx, torch.int64),
        dynamic_lmk_bary_coords=up(assets.dynamic_lmk_bary_coords),
        albedo_mean=up(np.asarray(assets.albedo_mean)[rows]),
        albedo_basis=up(np.asarray(assets.albedo_basis)[rows, :n_tex].T),
        vertex_face_adj=up(assets.vertex_face_adj, torch.int64),
        raster_rows=up(assets.raster_rows, torch.int64),
        raster_row_id=up(rid, torch.int64),
        raster_uv=raster_uv.contiguous(),
        sh_factor=up(SH_FACTOR),
        parents=tuple(int(p) for p in assets.parents),
        uv_size=uv_size, detail=detail)


# --- the model ---

def rodrigues(rvec) -> torch.Tensor:
    """Axis-angle (M, 3) -> rotation matrices (M, 3, 3), as DECA's
    batch_rodrigues: angle = |r + 1e-8|, direction r / angle."""
    m = rvec.shape[0]
    angle = torch.norm(rvec + 1e-8, dim=1, keepdim=True)
    rdir = rvec / angle
    cos = torch.cos(angle)[:, None]
    sin = torch.sin(angle)[:, None]
    rx, ry, rz = torch.split(rdir, 1, dim=1)
    zeros = torch.zeros((m, 1), dtype=rvec.dtype, device=rvec.device)
    k = torch.cat([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                  dim=1).view(m, 3, 3)
    ident = torch.eye(3, dtype=rvec.dtype, device=rvec.device)[None]
    return ident + sin * k + (1 - cos) * torch.bmm(k, k)


def full_pose(pose) -> torch.Tensor:
    """DECA's (B, 6) [global | jaw] -> FLAME's (B, 15) [global | neck 0 |
    jaw | eyes 0]."""
    z3 = pose.new_zeros((pose.shape[0], 3))
    return torch.cat([pose[:, :3], z3, pose[:, 3:], z3, z3], dim=1)


def _chain(rot, joints, parents):
    """The kinematic chain (batch_rigid_transform): rot (B, J, 3, 3),
    joints (B, J, 3) -> the relative transforms A (B, J, 4, 4)."""
    nj = joints.shape[1]
    j = joints[..., None]                                  # (B, J, 3, 1)
    # the parents by python ints: an index list would be a host copy,
    # which waits for the device
    rel = torch.cat([j[:, :1], j[:, 1:] - torch.stack(
        [j[:, p] for p in parents[1:]], dim=1)], dim=1)
    mats = torch.cat([F.pad(rot, [0, 0, 0, 1]),
                      F.pad(rel, [0, 0, 0, 1], value=1)], dim=3)
    chain = [mats[:, 0]]
    for i in range(1, nj):
        chain.append(torch.matmul(chain[parents[i]], mats[:, i]))
    tr = torch.stack(chain, dim=1)
    jh = F.pad(j, [0, 0, 0, 1])
    return tr - F.pad(torch.matmul(tr, jh), [3, 0])


def lbs(betas, pose15, flame: DeviceFLAME):
    """(posed vertices (B, N, 3), rotations (B, 5, 3, 3))."""
    bsz = betas.shape[0]
    n = flame.v_template.shape[0]
    v_shaped = flame.v_template + (betas @ flame.shapedirs.T).view(bsz, n, 3)
    joints = torch.matmul(flame.J_regressor, v_shaped)       # (B, 5, 3)
    rot = rodrigues(pose15.reshape(-1, 3)).view(bsz, -1, 3, 3)
    ident = torch.eye(3, dtype=rot.dtype, device=rot.device)
    feat = (rot[:, 1:] - ident).reshape(bsz, -1)             # (B, 36)
    v_posed = v_shaped + (feat @ flame.posedirs).view(bsz, n, 3)
    a = _chain(rot, joints, flame.parents)                   # (B, 5, 4, 4)
    t = torch.matmul(flame.lbs_weights, a.view(bsz, -1, 16)).view(
        bsz, n, 4, 4)
    homo = F.pad(v_posed, [0, 1], value=1.0)                 # (B, N, 4)
    verts = (t[:, :, :3, :] * homo[:, :, None, :]).sum(-1)
    return verts, rot


def contour_bin(rot) -> torch.Tensor:
    """(B,) int64: the contour table's row for the neck-then-root
    rotation's yaw (DECA's _find_dynamic_lmk_idx_and_bcoords)."""
    rel = torch.eye(3, dtype=rot.dtype, device=rot.device).expand(
        rot.shape[0], -1, -1)
    for idx in NECK_KIN_CHAIN:
        rel = torch.bmm(rot[:, idx], rel)
    sy = torch.sqrt(rel[:, 0, 0] * rel[:, 0, 0] + rel[:, 1, 0] * rel[:, 1, 0])
    deg = torch.atan2(-rel[:, 2, 0], sy) * 180.0 / np.pi
    yaw = torch.round(torch.clamp(deg, max=39)).to(torch.int64)
    neg = yaw < 0
    return torch.where(neg, torch.where(yaw < -39, 78, 39 - yaw), yaw)


def landmarks_3d(verts, bins, flame: DeviceFLAME) -> torch.Tensor:
    """(B, 68, 3): the 17 contour points of each image's bin, then the 51
    static ones, as barycentric points of their faces."""
    bsz = verts.shape[0]
    fidx = torch.cat([flame.dynamic_lmk_faces_idx[bins],
                      flame.lmk_faces_idx.expand(bsz, -1)], dim=1)
    bary = torch.cat([flame.dynamic_lmk_bary_coords[bins],
                      flame.lmk_bary_coords.expand(bsz, -1, -1)], dim=1)
    vid = flame.faces[fidx]                                  # (B, 68, 3)
    corners = torch.gather(verts, 1, vid.reshape(bsz, -1, 1).expand(
        -1, -1, 3)).view(bsz, -1, 3, 3)
    return (corners * bary[..., None]).sum(2)


def vertex_normals(verts, faces, adj, eps: float = 1e-6) -> torch.Tensor:
    """(B, N, 3): each vertex's sum of its faces' cross products (v1 -
    v0) x (v2 - v0) over max(|sum|, eps); adj (N, deg_max) the vertex's
    faces, padded with F (a zero normal)."""
    p = verts[:, faces]                                      # (B, F, 3, 3)
    fn = torch.linalg.cross(p[:, :, 1] - p[:, :, 0], p[:, :, 2] - p[:, :, 0],
                            dim=-1)
    vn = F.pad(fn, (0, 0, 0, 1))[:, adj].sum(2)              # (B, N, 3)
    return vn / torch.clamp(torch.linalg.vector_norm(vn, dim=-1,
                                                     keepdim=True), min=eps)


def orth_ndc(points, cam) -> torch.Tensor:
    """DECA's batch_orth_proj with y and z negated, as the raster's
    [x_ndc, y_ndc, depth]: [s(x + tx), s(y + ty), -s z] (y_ndc up, as
    ndc_to_screen takes it)."""
    s = cam[:, None, 0:1]
    xy = s * (points[..., :2] + cam[:, None, 1:])
    return torch.cat([xy, -(s * points[..., 2:])], dim=-1)


class FLAMEGeometry(NamedTuple):
    verts_world: torch.Tensor   # (B, N, 3) posed FLAME vertices
    verts_ndc: torch.Tensor     # (B, N, 3) [x_ndc, y_ndc, depth -s z]
    normals: torch.Tensor       # (B, N, 3) world vertex normals
    landmarks3d: torch.Tensor   # (B, 68, 3) world
    landmarks2d: torch.Tensor   # (B, 68, 2) pixel coordinates
    contour_bin: torch.Tensor   # (B,) int64 row of the contour table


def flame_geometry(c: DECACodes, flame: DeviceFLAME,
                   cfg: FaceReconConfig,
                   image_size: int | None = None) -> FLAMEGeometry:
    size = image_size or cfg.image_size
    betas = torch.cat([c.shape, c.exp], dim=1)
    verts, rot = lbs(betas, full_pose(c.pose), flame)
    bins = contour_bin(rot)
    lmk3d = landmarks_3d(verts, bins, flame)
    normals = vertex_normals(verts, flame.faces, flame.vertex_face_adj)
    return FLAMEGeometry(
        verts_world=verts, verts_ndc=orth_ndc(verts, c.cam),
        normals=normals, landmarks3d=lmk3d,
        landmarks2d=ndc_to_screen(orth_ndc(lmk3d, c.cam), size, size),
        contour_bin=bins)


def graphed(name: str, fn, flame: DeviceFLAME, *inputs):
    """fn(*inputs), a tuple of tensors, replayed from a CUDA graph when the
    inputs lie on the card (eager on the CPU). The pack keeps one graph
    for each name (flame.graphs), captured at the first call (after one
    warm-up run on a side stream) and captured anew, the old one freed
    first, when the inputs' shapes or device change: each call copies the
    inputs into the graph's own and replays it on the current stream. The
    outputs are the graph's static tensors, so the next call of the same
    graph overwrites them: copy what must outlive it."""
    if not inputs[0].is_cuda:
        return fn(*inputs)
    key = (inputs[0].device, tuple(tuple(x.shape) for x in inputs))
    entry = flame.graphs.get(name)
    if entry is None or entry[0] != key:
        flame.graphs.pop(name, None)
        static_in = tuple(x.clone() for x in inputs)
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = fn(*static_in)
        entry = flame.graphs[name] = (key, graph, static_in, static_out)
    _, graph, static_in, static_out = entry
    for dst, src in zip(static_in, inputs):
        dst.copy_(src)
    graph.replay()
    return static_out


def decode_albedo(tex, flame: DeviceFLAME) -> torch.Tensor:
    """(B, n_tex) -> (B, S, S, 3) RGB albedo: DECA's decode at the texels
    its nearest downsample keeps."""
    s = flame.uv_size
    return torch.addmm(flame.albedo_mean, tex, flame.albedo_basis).view(
        tex.shape[0], s, s, 3)
