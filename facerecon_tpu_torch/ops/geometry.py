"""Geometry core (twin of facerecon_tpu/ops/geometry.py).

Shape/texture synthesis, rigid pose, perspective projection, vertex
normals and landmarks, batched over a leading B axis. Everything is true
float32: the fidelity contract is closeness to the numpy oracle, and the
JAX reference measured 1.1e-3 vertex MAE and 84% tri_id agreement with
bf16 synthesis. On the card that means TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`, set by the pipeline).

`coeffs_to_geometry` takes one of two paths, chosen by autograd alone:
- where autograd records the call (grad enabled and a coefficient or a
  basis requires grad: training, fitting), the eager ops below, the twin
  of the reference with its gather-based adjoints;
- otherwise the basis products (`basis_products`, plain matrix products)
  and then `vertex_pass`: on CUDA tensors the kernel `csrc/geometry.cu`
  (one launch, two passes), on CPU tensors its plain version
  `vertex_pass_reference`. That path also lights the mesh with SH-9, so
  its Geometry carries the radiance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from facerecon_tpu_torch import resolve_device
from facerecon_tpu_torch.config import FaceReconConfig
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops.sh import SH_SCALES, illuminate
from facerecon_tpu_torch.utils.coeffs import Coeffs


class DeviceBFM(NamedTuple):
    """BFMAssets mirrored as tensors on one device."""
    mean_shape: torch.Tensor      # (3N,)
    id_basis: torch.Tensor        # (3N, K_id)
    exp_basis: torch.Tensor       # (3N, K_exp)
    mean_tex: torch.Tensor        # (3N,)
    tex_basis: torch.Tensor       # (3N, K_tex)
    sigma_id: torch.Tensor
    sigma_exp: torch.Tensor
    sigma_tex: torch.Tensor
    faces: torch.Tensor           # (F, 3) int64
    landmark_index: torch.Tensor  # (68,) int64
    skin_mask: torch.Tensor       # (N,) f32
    vertex_face_adj: torch.Tensor    # (N, deg_max) int64, F = pad
    vertex_corner_adj: torch.Tensor  # (N, deg_max) int64, 3F = pad
    face_adj_slot: torch.Tensor   # (F, 3) int64 flat v*deg_max+rank
    raster_rows: torch.Tensor     # (F', 3) int64 padded raster row order
    raster_row_id: torch.Tensor   # (F',) int64 face id per row, F+1 = pad
    raster_corner_adj: torch.Tensor  # (N, deg_max) int64: corner-major
                                  # row-ordered corner positions
                                  # (slot * F' + row); 3F' = pad
    vertex_corner_adj_cm: torch.Tensor  # (N, deg_max) int64: corner-major
                                  # original-face-order positions
                                  # (slot * F + face); 3F = pad
    raster_skin: torch.Tensor     # (3, F') f32 skin mask per raster corner


def device_bfm(assets, device="cuda") -> DeviceBFM:
    """Upload an asset pack once. Index tables become int64 (torch's
    index type); the three derived tables are computed in numpy exactly
    as the JAX package computes them."""
    dev = resolve_device(device)
    derived = ("raster_corner_adj", "vertex_corner_adj_cm", "raster_skin")
    vals = {}
    for name in DeviceBFM._fields:
        if name in derived:
            continue
        a = np.asarray(getattr(assets, name))
        vals[name] = (a.astype(np.int64) if a.dtype.kind in "iu"
                      else a.astype(np.float32))
    vca = np.asarray(assets.vertex_corner_adj)      # flat face*3+slot
    rid = np.asarray(assets.raster_row_id)
    n_f = assets.faces.shape[0]
    n_rows = rid.shape[0]
    row_of_face = np.zeros(n_f, np.int64)
    live = rid < n_f
    row_of_face[rid[live]] = np.nonzero(live)[0]
    face = np.clip(vca // 3, 0, n_f - 1)
    vals["raster_corner_adj"] = np.where(
        vca >= 3 * n_f, 3 * n_rows, (vca % 3) * n_rows + row_of_face[face])
    vals["vertex_corner_adj_cm"] = np.where(
        vca >= 3 * n_f, 3 * n_f, (vca % 3) * n_f + face)
    rows = np.asarray(assets.raster_rows)
    vals["raster_skin"] = np.asarray(assets.skin_mask, np.float32)[rows.T]
    return DeviceBFM(**{k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
                        for k, v in vals.items()})


# --- shape/texture synthesis ---

def shape_formation(alpha, beta, bfm: DeviceBFM) -> torch.Tensor:
    """S = S_mean + A_id alpha + A_exp beta  -> (B, N, 3)."""
    flat = (bfm.mean_shape[None, :]
            + alpha @ bfm.id_basis.T
            + beta @ bfm.exp_basis.T)
    return flat.reshape(alpha.shape[0], -1, 3)


def texture_formation(delta, bfm: DeviceBFM) -> torch.Tensor:
    """T = T_mean + A_tex delta, scaled to [0,1] -> (B, N, 3)."""
    flat = bfm.mean_tex[None, :] + delta @ bfm.tex_basis.T
    return (flat / 255.0).reshape(delta.shape[0], -1, 3)


# --- rigid pose ---

def compute_rotation(angles) -> torch.Tensor:
    """Euler radians (B,3) -> R = Rz(psi) Ry(phi) Rx(theta), (B,3,3)."""
    theta, phi, psi = angles[..., 0], angles[..., 1], angles[..., 2]
    one = torch.ones_like(theta)
    zero = torch.zeros_like(theta)

    def mat(*entries):
        return torch.stack(entries, -1).reshape(*theta.shape, 3, 3)

    c, s = torch.cos, torch.sin
    rx = mat(one, zero, zero,
             zero, c(theta), -s(theta),
             zero, s(theta), c(theta))
    ry = mat(c(phi), zero, s(phi),
             zero, one, zero,
             -s(phi), zero, c(phi))
    rz = mat(c(psi), -s(psi), zero,
             s(psi), c(psi), zero,
             zero, zero, one)
    return rz @ ry @ rx


def rigid_transform(shape, rotation, trans) -> torch.Tensor:
    """V = S R^T + t : (B,N,3),(B,3,3),(B,3) -> (B,N,3)."""
    return shape @ rotation.transpose(-1, -2) + trans[:, None, :]


# --- camera & projection ---

def camera_depth(verts, cfg: FaceReconConfig) -> torch.Tensor:
    """z' = c - V_z (camera at (0,0,c) looking down -z)."""
    return cfg.camera_distance - verts[..., 2]


def perspective_projection(verts, cfg: FaceReconConfig) -> torch.Tensor:
    """World verts (B,N,3) -> pixel coords (B,N,2), image y down."""
    zp = camera_depth(verts, cfg)
    u = cfg.focal * verts[..., 0] / zp + cfg.center
    v = cfg.center - cfg.focal * verts[..., 1] / zp
    return torch.stack([u, v], dim=-1)


def to_ndc(verts, cfg: FaceReconConfig) -> torch.Tensor:
    """World verts -> (B,N,3) [x_ndc, y_ndc, depth z'] for the rasterizer."""
    zp = camera_depth(verts, cfg)
    half = cfg.image_size / 2.0
    x_ndc = cfg.focal * verts[..., 0] / zp / half
    y_ndc = cfg.focal * verts[..., 1] / zp / half
    return torch.stack([x_ndc, y_ndc, zp], dim=-1)


# --- fixed-adjacency gathers with gather-based adjoints ---

def _gather_sum(p, adj):
    """sum_k p_pad[..., adj[:, k]] in the order k = 0..deg-1, where p_pad
    is p with one zero appended (the pad index of `adj`)."""
    p_pad = torch.cat([p, p.new_zeros((*p.shape[:-1], 1))], dim=-1)
    total = p_pad[..., adj[:, 0]]
    for k in range(1, adj.shape[1]):
        total = total + p_pad[..., adj[:, k]]
    return total


class _TakeCornerPlanes(torch.autograd.Function):
    """Per-vertex planes (B, N) -> corner planes (B, len(idx)) by a gather
    along the last axis. Backward: each vertex sums the cotangents of its
    corners through the fixed `corner_adj` table ((N, deg_max) corner
    positions, padded with len(idx)) — a gather, not the scatter-add
    (index_put_ with accumulate, atomics on the card) that autograd
    derives from p[..., idx]."""

    @staticmethod
    def forward(ctx, idx, corner_adj, *planes):
        ctx.save_for_backward(corner_adj)
        return tuple(p[..., idx] for p in planes)

    @staticmethod
    def backward(ctx, *grads):
        (corner_adj,) = ctx.saved_tensors
        return (None, None, *(_gather_sum(g, corner_adj) for g in grads))


def take_corner_planes(planes, idx, corner_adj):
    """Tuple of (B, N) planes -> tuple of (B, len(idx)) corner planes
    (twin of the reference's take_corner_planes custom VJP)."""
    return _TakeCornerPlanes.apply(idx, corner_adj, *planes)


class _AccumulateFnPlanes(torch.autograd.Function):
    """Face-normal planes (B, F) -> vertex sums (B, N) over each vertex's
    adjacent faces (`adj` (N, deg_max) vertex -> face, padded with F),
    summed in the order k = 0..deg-1. Backward: d fn[f] = sum_c
    g[faces[f, c]], three gathers (twin of the reference's
    _accumulate_fn_planes)."""

    @staticmethod
    def forward(ctx, adj, faces, *fn_planes):
        ctx.save_for_backward(faces)
        return tuple(_gather_sum(p, adj) for p in fn_planes)

    @staticmethod
    def backward(ctx, *grads):
        (faces,) = ctx.saved_tensors
        return (None, None, *(g[..., faces[:, 0]] + g[..., faces[:, 1]]
                              + g[..., faces[:, 2]] for g in grads))


# --- vertex normals (area-weighted) ---

def compute_norm(verts, faces, adj, corner_adj_cm) -> torch.Tensor:
    """Per-vertex normals: area-weighted face normals summed per vertex,
    in the reference's PLANE form (per-component corner gathers).

    `corner_adj_cm` ((N, deg_max) corner-major corner positions, padded
    with 3F) gives the corner gather its gather-based adjoint; `adj`
    ((N, deg_max) vertex->face table, padded with F) drives the
    accumulation, which sums each vertex's adjacent face normals in the
    order k = 0..deg-1, as the reference does. No index_add_ or scatter
    in either direction: on CUDA their atomics sum in an order that
    changes between runs."""
    f = faces.shape[0]
    idx_cm = faces.T.reshape(-1)                        # corner-major
    cx, cy, cz = take_corner_planes(
        tuple(verts[..., k] for k in range(3)), idx_cm, corner_adj_cm)

    def corner(p, c):
        return p[..., c * f:(c + 1) * f]

    ax = corner(cx, 1) - corner(cx, 0)                  # v1 - v0
    ay = corner(cy, 1) - corner(cy, 0)
    az = corner(cz, 1) - corner(cz, 0)
    bx = corner(cx, 2) - corner(cx, 0)                  # v2 - v0
    by = corner(cy, 2) - corner(cy, 0)
    bz = corner(cz, 2) - corner(cz, 0)
    fn = (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)
    vx, vy, vz = _AccumulateFnPlanes.apply(adj, faces, *fn)
    norm = torch.sqrt(vx * vx + vy * vy + vz * vz)[..., None]
    return torch.stack([vx, vy, vz], dim=-1) / torch.clamp(norm, min=1e-8)


# --- landmark projection ---

def project_landmarks(verts, bfm: DeviceBFM, cfg: FaceReconConfig):
    """Gather the 68 landmark vertices and project to 2D pixels (B,68,2)."""
    return perspective_projection(verts[:, bfm.landmark_index], cfg)


# --- full coefficient -> world geometry helper ---

class Geometry(NamedTuple):
    shape: torch.Tensor        # (B,N,3) canonical shape
    verts_world: torch.Tensor  # (B,N,3) posed
    verts_ndc: torch.Tensor    # (B,N,3) [x_ndc,y_ndc,depth]
    texture: torch.Tensor      # (B,N,3) albedo [0,1]
    normals: torch.Tensor      # (B,N,3) world-space vertex normals
    landmarks2d: torch.Tensor  # (B,68,2) pixel coords
    radiance: Optional[torch.Tensor] = None  # (B,N,3) SH-9 radiance under
                                             # the coefficients' gamma
                                             # (the forward-only path)


def autograd_records(*tensors) -> bool:
    """True where autograd records an op on these tensors: grad enabled
    and any of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def coeffs_to_geometry(c: Coeffs, bfm: DeviceBFM,
                       cfg: FaceReconConfig) -> Geometry:
    """Coefficients -> Geometry. Where autograd records the call, the
    eager differentiable ops (radiance None); otherwise the basis products
    and `vertex_pass` (the kernel on the card), with the radiance."""
    if not autograd_records(*c, bfm.mean_shape, bfm.id_basis,
                            bfm.exp_basis, bfm.mean_tex, bfm.tex_basis):
        return vertex_pass(basis_products(c, bfm), c, bfm, cfg)
    shape = shape_formation(c.id, c.exp, bfm)
    tex = texture_formation(c.tex, bfm)
    rot = compute_rotation(c.angles)
    verts = rigid_transform(shape, rot, c.trans)
    # normals rotate with the mesh: compute in canonical frame, rotate
    normals = compute_norm(shape, bfm.faces, bfm.vertex_face_adj,
                           bfm.vertex_corner_adj_cm)
    normals = normals @ rot.transpose(-1, -2)
    return Geometry(
        shape=shape,
        verts_world=verts,
        verts_ndc=to_ndc(verts, cfg),
        texture=tex,
        normals=normals,
        landmarks2d=project_landmarks(verts, bfm, cfg),
    )


# --- the forward-only path: basis products, then one vertex pass ---

def basis_products(c: Coeffs, bfm: DeviceBFM):
    """The three (B, 3N) basis products A_id alpha, A_exp beta and
    A_tex delta, as shape_formation and texture_formation compute them."""
    return (c.id @ bfm.id_basis.T, c.exp @ bfm.exp_basis.T,
            c.tex @ bfm.tex_basis.T)


def vertex_pass_reference(parts, c: Coeffs, bfm: DeviceBFM,
                          cfg: FaceReconConfig) -> Geometry:
    """Plain PyTorch version of the geometry kernel, on any device: from
    the basis products `parts` to the Geometry with its radiance. It is
    the eager path's forward op for op (the same functions, so the same
    numbers bit for bit), and the kernel's float32 operations in their
    order, but for the rotation's three 3x3 products: here the library's
    matmuls, which sum the three terms in their own order (fused on the
    card); the kernel sums them in k order, unfused."""
    id_part, exp_part, tex_part = parts
    bsz = id_part.shape[0]
    shape = (bfm.mean_shape[None, :] + id_part + exp_part).reshape(bsz, -1, 3)
    tex = ((bfm.mean_tex[None, :] + tex_part) / 255.0).reshape(bsz, -1, 3)
    rot = compute_rotation(c.angles)
    verts = rigid_transform(shape, rot, c.trans)
    normals = compute_norm(shape, bfm.faces, bfm.vertex_face_adj,
                           bfm.vertex_corner_adj_cm) @ rot.transpose(-1, -2)
    return Geometry(
        shape=shape,
        verts_world=verts,
        verts_ndc=to_ndc(verts, cfg),
        texture=tex,
        normals=normals,
        landmarks2d=project_landmarks(verts, bfm, cfg),
        radiance=illuminate(tex, normals, c.gamma),
    )


def vertex_pass(parts, c: Coeffs, bfm: DeviceBFM,
                cfg: FaceReconConfig) -> Geometry:
    """The basis products `parts` ((B, 3N) f32 each) -> the Geometry with
    its radiance. CPU tensors take the plain version
    (vertex_pass_reference); CUDA tensors launch `csrc/geometry.cu` once
    (the shape pass, then one thread a vertex and a landmark), which has
    no backward: the inputs f32 and contiguous, the angles, gamma and
    trans f32 rows whose last axis is contiguous (views of one
    coefficient row do), the index tables int64, or it raises."""
    dev = parts[0].device
    if not _build.on_card(dev):
        return vertex_pass_reference(parts, c, bfm, cfg)
    id_part, exp_part, tex_part = parts
    bsz, plane = id_part.shape
    n = plane // 3
    f = bfm.faces.shape[0]
    deg = bfm.vertex_face_adj.shape[1]
    n_lmk = bfm.landmark_index.shape[0]
    f32, i64 = torch.float32, torch.int64
    _build.check_tensors(dev, {
        "id_part": (id_part, f32, (bsz, 3 * n)),
        "exp_part": (exp_part, f32, (bsz, 3 * n)),
        "tex_part": (tex_part, f32, (bsz, 3 * n)),
        "mean_shape": (bfm.mean_shape, f32, (3 * n,)),
        "mean_tex": (bfm.mean_tex, f32, (3 * n,)),
        "faces": (bfm.faces, i64, (f, 3)),
        "vertex_face_adj": (bfm.vertex_face_adj, i64, (n, deg)),
        "landmark_index": (bfm.landmark_index, i64, (n_lmk,)),
    })
    for name, width in (("angles", 3), ("gamma", 27), ("trans", 3)):
        t = getattr(c, name)
        if (t.device != dev or t.dtype != f32
                or tuple(t.shape) != (bsz, width) or t.stride(-1) != 1):
            raise ValueError(f"{name}: expected f32 ({bsz}, {width}) rows "
                             f"with a contiguous last axis on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} stride "
                             f"{t.stride()} on {t.device}")
    out = [torch.empty((bsz, n, 3), dtype=f32, device=dev) for _ in range(6)]
    lmk = torch.empty((bsz, n_lmk, 2), dtype=f32, device=dev)
    if bsz:
        _build.launch(
            "geometry", dev,
            (id_part, exp_part, tex_part, bfm.mean_shape, bfm.mean_tex,
             c.angles, c.gamma, c.trans, bfm.faces, bfm.vertex_face_adj,
             bfm.landmark_index, *out, lmk),
            (bsz, n, f, deg, n_lmk, c.angles.stride(0), c.gamma.stride(0),
             c.trans.stride(0)),
            floats=(cfg.focal, cfg.camera_distance, cfg.center,
                    cfg.image_size / 2.0, *SH_SCALES))
    shape, verts, ndc, normals, tex, radiance = out
    return Geometry(shape=shape, verts_world=verts, verts_ndc=ndc,
                    texture=tex, normals=normals, landmarks2d=lmk,
                    radiance=radiance)
