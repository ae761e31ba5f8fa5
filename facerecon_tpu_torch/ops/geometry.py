"""Geometry core (twin of facerecon_tpu/ops/geometry.py).

Shape/texture synthesis, rigid pose, perspective projection, vertex
normals and landmarks, batched over a leading B axis. Everything is true
float32: the fidelity contract is closeness to the numpy oracle, and the
JAX reference measured 1.1e-3 vertex MAE and 84% tri_id agreement with
bf16 synthesis. On the card that means TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`, set by the pipeline).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from facerecon_tpu_torch import resolve_device
from facerecon_tpu_torch.config import FaceReconConfig
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


def coeffs_to_geometry(c: Coeffs, bfm: DeviceBFM,
                       cfg: FaceReconConfig) -> Geometry:
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
