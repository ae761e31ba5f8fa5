"""3DMM geometry and SH-9 shading (Deng et al., arXiv:1903.08527, with
the Basel Face Model's layout), plain float32, batched over B.

coefficients (B, 257) = [id 80 | exp 64 | tex 80 | angles 3 | gamma 27 |
t 3]: shape = mean + A_id id + A_exp exp; albedo = (mean_tex + A_tex
tex) / 255; R = Rz Ry Rx from the Euler angles; posed = shape R^T + t;
a pinhole camera at (0, 0, camera_distance) looking down -z with the
image's y axis down; vertex normals are the sums of the adjacent faces'
cross products, normalised, rotated with the mesh; radiance = albedo *
(Y(n) . (gamma_c + e_dc)), the 9 SH terms scaled by the Lambertian
constants."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from perfbench.reference import quant

_A0, _A1, _A2 = math.pi, 2.0 * math.pi / math.sqrt(3.0), \
    2.0 * math.pi / math.sqrt(8.0)
_C0 = 1.0 / math.sqrt(4.0 * math.pi)
_C1 = math.sqrt(3.0) / math.sqrt(4.0 * math.pi)
_C2 = 3.0 * math.sqrt(5.0) / math.sqrt(12.0 * math.pi)
SH_SCALES = (_A0 * _C0, -_A1 * _C1, _A1 * _C1, -_A1 * _C1, _A2 * _C2,
             -_A2 * _C2, _A2 * _C2 / (2.0 * math.sqrt(3.0)), -_A2 * _C2,
             _A2 * _C2 / 2.0)


class Mesh(NamedTuple):
    """The benchmark's mesh arrays as tensors on one device."""
    mean_shape: torch.Tensor   # (3N,)
    id_basis: torch.Tensor     # (3N, K_id)
    exp_basis: torch.Tensor    # (3N, K_exp)
    mean_tex: torch.Tensor     # (3N,)
    tex_basis: torch.Tensor    # (3N, K_tex)
    sigma_id: torch.Tensor
    sigma_exp: torch.Tensor
    sigma_tex: torch.Tensor
    faces: torch.Tensor        # (F, 3) int64
    landmark_index: torch.Tensor  # (68,) int64
    skin_mask: torch.Tensor    # (N,)


def mesh_on(arrays: dict, device) -> Mesh:
    vals = {}
    for name in Mesh._fields:
        t = torch.as_tensor(arrays[name])
        vals[name] = (t.to(torch.int64) if not t.is_floating_point()
                      else t.to(torch.float32)).to(device)
    return Mesh(**vals)


class Geometry(NamedTuple):
    verts: torch.Tensor      # (B, N, 3) posed, world units
    screen: torch.Tensor     # (B, N, 2) pixel coordinates (x right, y down)
    depth: torch.Tensor      # (B, N) camera depth z' = distance - z
    radiance: torch.Tensor   # (B, N, 3)
    landmarks: torch.Tensor  # (B, 68, 2) pixel coordinates


def split(coeff, sizes: dict):
    names = ("n_id", "n_exp", "n_tex", "n_angles", "n_gamma", "n_trans")
    return torch.split(coeff, [sizes[k] for k in names], dim=-1)


def rotation(angles):
    t, p, s = angles[:, 0], angles[:, 1], angles[:, 2]
    one, zero = torch.ones_like(t), torch.zeros_like(t)

    def mat(*e):
        return torch.stack(e, -1).reshape(-1, 3, 3)

    rx = mat(one, zero, zero, zero, torch.cos(t), -torch.sin(t),
             zero, torch.sin(t), torch.cos(t))
    ry = mat(torch.cos(p), zero, torch.sin(p), zero, one, zero,
             -torch.sin(p), zero, torch.cos(p))
    rz = mat(torch.cos(s), -torch.sin(s), zero, torch.sin(s), torch.cos(s),
             zero, zero, zero, one)
    return rz @ ry @ rx


def vertex_normals(shape, faces):
    """(B, N, 3) -> unit vertex normals: the adjacent faces' cross
    products summed."""
    v0, v1, v2 = (shape[:, faces[:, k]] for k in range(3))
    fn = torch.cross(v1 - v0, v2 - v0, dim=-1)
    acc = torch.zeros_like(shape)
    for k in range(3):
        acc = acc.index_add(1, faces[:, k], fn)
    norm = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
    return acc / torch.clamp(norm, min=1e-8)


def illuminate(albedo, normals, gamma):
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    ys = (torch.ones_like(nx), ny, nz, nx, nx * ny, ny * nz,
          3.0 * nz * nz - 1.0, nx * nz, nx * nx - ny * ny)
    basis = torch.stack([y * s for y, s in zip(ys, SH_SCALES)], dim=-1)
    g = gamma.reshape(-1, 3, 9).clone()
    g[:, :, 0] = g[:, :, 0] + 1.0
    light = basis @ g.transpose(1, 2)                      # (B, N, 3)
    return albedo * light


def geometry(coeff, mesh: Mesh, cam: dict, sizes: dict,
             precision: str = "f32") -> Geometry:
    """coefficients (B, n_coeff) -> posed vertices, screen positions,
    depth, radiance and the 68 landmarks. cam: image_size, focal,
    camera_distance."""
    cid, cexp, ctex, angles, gamma, trans = split(coeff, sizes)
    mm = lambda a, b: quant.matmul(a, b, precision)  # noqa: E731
    b = coeff.shape[0]
    shape = (mesh.mean_shape + mm(cid, mesh.id_basis.T)
             + mm(cexp, mesh.exp_basis.T)).reshape(b, -1, 3)
    albedo = ((mesh.mean_tex + mm(ctex, mesh.tex_basis.T)) / 255.0
              ).reshape(b, -1, 3)
    rot = rotation(angles)
    verts = mm(shape, rot.transpose(1, 2)) + trans[:, None, :]
    normals = mm(vertex_normals(shape, mesh.faces), rot.transpose(1, 2))
    radiance = illuminate(albedo, normals, gamma)
    size, focal = cam["image_size"], cam["focal"]
    depth = cam["camera_distance"] - verts[..., 2]
    u = focal * verts[..., 0] / depth + size / 2.0
    v = size / 2.0 - focal * verts[..., 1] / depth
    screen = torch.stack([u, v], dim=-1)
    return Geometry(verts=verts, screen=screen, depth=depth,
                    radiance=radiance,
                    landmarks=screen[:, mesh.landmark_index])
