"""DECA's coarse forward (Feng, Feng, Black, Bolkart, SIGGRAPH 2021,
arXiv:2012.04012; github.com/yfeng95/DECA) from its codes, in plain
float32 PyTorch with TF32 off: FLAME (decalib/models/FLAME.py and
lbs.py), the BFM-derived albedo (FLAMETex), batch_orth_proj and the
coarse renderer (utils/renderer.py SRenderY with the PyTorch3D
rasterizer, utils/util.py). It imports nothing of the program.

codes (B, 236) = [shape 100 | tex 50 | exp 50 | pose 6 | cam 3 |
light 27]:
  - FLAME: v_shaped = template + shapedirs . [shape | exp]; the full pose
    [global | neck 0 | jaw | eyes 0] through batch_rodrigues (angle =
    |r + 1e-8|); pose correctives (R_j - I, joints 1-4) . posedirs; the
    joints J_regressor . v_shaped, the chain (batch_rigid_transform),
    T = W . A, v = T . [v_posed, 1];
  - landmarks: 17 contour points from the (79, 17) table at the bin of
    the neck-then-root rotation's yaw (rot_mat_to_euler, round(clamp(deg,
    max=39)), 39 - yaw for a negative one, 78 below -39), then 51 static
    ones, each a barycentric point of a face (vertices2landmarks);
  - the albedo: mean + basis . tex over all A x A x 3 texels, reshaped
    to (B, 3, A, A), F.interpolate to S x S (nearest), BGR -> RGB;
  - the camera: batch_orth_proj, s (x + tx, y + ty, z), y and z negated;
    landmarks in pixels l * S / 2 + S / 2;
  - the render: DECA's vertex_normals of the world vertices (index_add_
    of each corner's cross product, F.normalize), interpolated per pixel
    with the winner's barycentrics and not renormalised; SH-9 with DECA's
    constant_factor, basis [1, x, y, z, xy, xz, yz, x^2 - y^2, 3z^2 - 1],
    light (9, 3); the albedo read by F.grid_sample (bilinear,
    align_corners=False, zeros) at the UVs interpolated over the UV
    topology (uvcoords * 2 - 1, v negated, by uvfaces); image = albedo x
    shading x coverage.

Departures from DECA's code, none of which changes the function at these
sizes:
  - the z-buffer is reference/raster.py's (pixel centres, a centre on an
    edge covered, the lowest depth -s z wins, ties to the lowest face id)
    in place of PyTorch3D's rasterize_meshes (a strict inside test, its
    own tie order); DECA's +10 depth offset and the near and far planes
    of its rasterizer, which never clip here, are left out;
  - the albedo decode is mean + tex @ basis^T, a matrix product, where
    FLAMETex sums basis * tex over the components (the same sum, a
    (B, 3 A^2, K) temporary less);
  - batched products are written with matmul where DECA writes einsum.

`precision` selects the control's arithmetic: "f32" is the reference;
"tf32" rounds every matrix product's inputs to TF32's 10-bit mantissa
(quant.matmul), as the card's tensor cores would with TF32 on."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from perfbench.reference import quant, raster

_PI = math.pi
SH_FACTOR = (1 / math.sqrt(4 * _PI),
             ((2 * _PI) / 3) * math.sqrt(3 / (4 * _PI)),
             ((2 * _PI) / 3) * math.sqrt(3 / (4 * _PI)),
             ((2 * _PI) / 3) * math.sqrt(3 / (4 * _PI)),
             (_PI / 4) * 3 * math.sqrt(5 / (12 * _PI)),
             (_PI / 4) * 3 * math.sqrt(5 / (12 * _PI)),
             (_PI / 4) * 3 * math.sqrt(5 / (12 * _PI)),
             (_PI / 4) * (3 / 2) * math.sqrt(5 / (12 * _PI)),
             (_PI / 4) * (1 / 2) * math.sqrt(5 / (4 * _PI)))
SIZES = (("shape", 100), ("tex", 50), ("exp", 50), ("pose", 6), ("cam", 3),
         ("light", 27))
NECK_KIN_CHAIN = (1, 0)


class Flame(NamedTuple):
    """The FLAME and albedo arrays (perfbench/flame_data.py's names) as
    tensors on one device."""
    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    J_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    parents: torch.Tensor
    faces: torch.Tensor
    uvcoords: torch.Tensor
    uvfaces: torch.Tensor
    lmk_faces_idx: torch.Tensor
    lmk_bary_coords: torch.Tensor
    dynamic_lmk_faces_idx: torch.Tensor
    dynamic_lmk_bary_coords: torch.Tensor
    albedo_mean: torch.Tensor
    albedo_basis: torch.Tensor


def flame_on(arrays: dict, device) -> Flame:
    vals = {}
    for name in Flame._fields:
        t = torch.as_tensor(arrays[name])
        vals[name] = (t.to(torch.int64) if not t.is_floating_point()
                      else t.to(torch.float32)).to(device)
    return Flame(**vals)


def split(codes, sizes=SIZES) -> dict:
    out, at = {}, 0
    for name, n in sizes:
        out[name] = codes[:, at:at + n]
        at += n
    return out


def _mm(a, b, precision):
    return quant.matmul(a, b, precision)


# --- FLAME (lbs.py) ---

def batch_rodrigues(rot_vecs, precision="f32"):
    batch_size = rot_vecs.shape[0]
    dev = rot_vecs.device
    angle = torch.norm(rot_vecs + 1e-8, dim=1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.unsqueeze(torch.cos(angle), dim=1)
    sin = torch.unsqueeze(torch.sin(angle), dim=1)
    rx, ry, rz = torch.split(rot_dir, 1, dim=1)
    zeros = torch.zeros((batch_size, 1), device=dev)
    k = torch.cat([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                  dim=1).view((batch_size, 3, 3))
    ident = torch.eye(3, device=dev).unsqueeze(dim=0)
    return ident + sin * k + (1 - cos) * _mm(k, k, precision)


def batch_rigid_transform(rot_mats, joints, parents, precision="f32"):
    joints = torch.unsqueeze(joints, dim=-1)
    rel_joints = joints.clone()
    rel_joints[:, 1:] -= joints[:, parents[1:]]
    transforms_mat = torch.cat(
        [F.pad(rot_mats.reshape(-1, 3, 3), [0, 0, 0, 1]),
         F.pad(rel_joints.reshape(-1, 3, 1), [0, 0, 0, 1], value=1)],
        dim=2).view(-1, joints.shape[1], 4, 4)
    chain = [transforms_mat[:, 0]]
    for i in range(1, parents.shape[0]):
        chain.append(_mm(chain[int(parents[i])], transforms_mat[:, i],
                         precision))
    transforms = torch.stack(chain, dim=1)
    joints_homogen = F.pad(joints, [0, 0, 0, 1])
    return transforms - F.pad(_mm(transforms, joints_homogen, precision),
                              [3, 0, 0, 0, 0, 0, 0, 0])


def flame(shape, exp, pose, fl: Flame, precision="f32"):
    """(vertices (B, N, 3), landmarks (B, 68, 3), contour bins (B,))."""
    bsz = shape.shape[0]
    n = fl.v_template.shape[0]
    betas = torch.cat([shape, exp], dim=1)
    z3 = torch.zeros((bsz, 3), device=shape.device)
    full_pose = torch.cat([pose[:, :3], z3, pose[:, 3:], z3, z3], dim=1)
    l_all = fl.shapedirs.shape[2]
    v_shaped = fl.v_template + _mm(
        betas, fl.shapedirs.reshape(n * 3, l_all).T, precision).view(bsz, n, 3)
    joints = _mm(fl.J_regressor, v_shaped, precision)
    rot_mats = batch_rodrigues(full_pose.view(-1, 3), precision).view(
        bsz, -1, 3, 3)
    ident = torch.eye(3, device=shape.device)
    pose_feature = (rot_mats[:, 1:, :, :] - ident).view(bsz, -1)
    v_posed = v_shaped + _mm(pose_feature, fl.posedirs, precision).view(
        bsz, -1, 3)
    a = batch_rigid_transform(rot_mats, joints, fl.parents, precision)
    w = fl.lbs_weights.unsqueeze(dim=0).expand(bsz, -1, -1)
    t = _mm(w, a.view(bsz, -1, 16), precision).view(bsz, -1, 4, 4)
    homo = torch.cat([v_posed, torch.ones((bsz, n, 1), device=shape.device)],
                     dim=2)
    verts = _mm(t, homo.unsqueeze(-1), precision)[:, :, :3, 0]
    bins = contour_bins(rot_mats, precision)
    fidx = torch.cat([fl.dynamic_lmk_faces_idx[bins],
                      fl.lmk_faces_idx.expand(bsz, -1)], 1)
    bary = torch.cat([fl.dynamic_lmk_bary_coords[bins],
                      fl.lmk_bary_coords.expand(bsz, -1, -1)], 1)
    return verts, vertices2landmarks(verts, fl.faces, fidx, bary,
                                     precision), bins


def contour_bins(rot_mats, precision="f32"):
    bsz = rot_mats.shape[0]
    rel = torch.eye(3, device=rot_mats.device).unsqueeze(0).expand(
        bsz, -1, -1)
    for idx in NECK_KIN_CHAIN:
        rel = _mm(rot_mats[:, idx], rel, precision)
    sy = torch.sqrt(rel[:, 0, 0] * rel[:, 0, 0] + rel[:, 1, 0] * rel[:, 1, 0])
    y_rot = torch.round(torch.clamp(torch.atan2(-rel[:, 2, 0], sy) * 180.0
                                    / _PI, max=39)).to(torch.long)
    neg_mask = y_rot.lt(0).to(torch.long)
    mask = y_rot.lt(-39).to(torch.long)
    neg_vals = mask * 78 + (1 - mask) * (39 - y_rot)
    return neg_mask * neg_vals + (1 - neg_mask) * y_rot


def vertices2landmarks(vertices, faces, lmk_faces_idx, lmk_bary_coords,
                       precision="f32"):
    bsz, nv = vertices.shape[:2]
    lmk_faces = faces[lmk_faces_idx.reshape(-1)].view(bsz, -1, 3)
    lmk_faces = lmk_faces + torch.arange(
        bsz, device=vertices.device).view(-1, 1, 1) * nv
    lmk_vertices = vertices.reshape(-1, 3)[lmk_faces].view(bsz, -1, 3, 3)
    # einsum('blfi,blf->bli'): a product over the three corners
    return _mm(lmk_bary_coords.unsqueeze(2), lmk_vertices,
               precision).squeeze(2)


# --- albedo (FLAMETex) ---

def albedo(tex, fl: Flame, uv_size: int, precision="f32"):
    """(B, 3, S, S) RGB."""
    bsz = tex.shape[0]
    a = int(round((fl.albedo_mean.shape[0] // 3) ** 0.5))
    k = tex.shape[1]
    texture = fl.albedo_mean + _mm(tex, fl.albedo_basis[:, :k].T, precision)
    texture = texture.reshape(bsz, a, a, 3).permute(0, 3, 1, 2)
    texture = F.interpolate(texture, [uv_size, uv_size])
    return texture[:, [2, 1, 0], :, :]


# --- camera and render (util.py, renderer.py) ---

def batch_orth_proj(x, camera):
    camera = camera.clone().view(-1, 1, 3)
    x_trans = x[:, :, :2] + camera[:, :, 1:]
    x_trans = torch.cat([x_trans, x[:, :, 2:]], 2)
    return camera[:, :, 0:1] * x_trans


def vertex_normals(vertices, faces):
    bs, nv = vertices.shape[:2]
    dev = vertices.device
    normals = torch.zeros(bs * nv, 3, device=dev)
    faces = faces[None] + (torch.arange(bs, device=dev) * nv)[:, None, None]
    vf = vertices.reshape((bs * nv, 3))[faces.long()]
    faces = faces.reshape(-1, 3)
    vf = vf.reshape(-1, 3, 3)
    normals.index_add_(0, faces[:, 1].long(), torch.cross(
        vf[:, 2] - vf[:, 1], vf[:, 0] - vf[:, 1], dim=1))
    normals.index_add_(0, faces[:, 2].long(), torch.cross(
        vf[:, 0] - vf[:, 2], vf[:, 1] - vf[:, 2], dim=1))
    normals.index_add_(0, faces[:, 0].long(), torch.cross(
        vf[:, 1] - vf[:, 0], vf[:, 2] - vf[:, 0], dim=1))
    return F.normalize(normals, eps=1e-6, dim=1).reshape((bs, nv, 3))


def add_sh_light(normal_images, sh_coeff):
    """normal_images (B, 3, H, W), sh_coeff (B, 9, 3) -> (B, 3, H, W)."""
    n = normal_images
    sh = torch.stack([n[:, 0] * 0. + 1., n[:, 0], n[:, 1], n[:, 2],
                      n[:, 0] * n[:, 1], n[:, 0] * n[:, 2], n[:, 1] * n[:, 2],
                      n[:, 0] ** 2 - n[:, 1] ** 2, 3 * (n[:, 2] ** 2) - 1], 1)
    sh = sh * torch.tensor(SH_FACTOR, device=n.device)[None, :, None, None]
    return torch.sum(sh_coeff[:, :, :, None, None] * sh[:, :, None, :, :], 1)


class Render(NamedTuple):
    verts: torch.Tensor       # (B, N, 3) world
    landmarks: torch.Tensor   # (B, 68, 2) pixels
    bins: torch.Tensor        # (B,) contour table rows
    tri_id: torch.Tensor      # (B, H, W) int64, -1 = background
    uv: torch.Tensor          # (B, H, W, 2) grid coordinates (0 off face)
    image: torch.Tensor       # (B, H, W, 3)


def render(codes, fl: Flame, size: int, uv_size: int,
           precision: str = "f32") -> Render:
    """DECA's coarse forward from codes (B, 236) at size x size px."""
    c = split(codes)
    bsz = codes.shape[0]
    verts, lmk3d, bins = flame(c["shape"], c["exp"], c["pose"], fl,
                               precision)
    lmk = batch_orth_proj(lmk3d, c["cam"])[:, :, :2]
    lmk = torch.cat([lmk[:, :, :1], -lmk[:, :, 1:]], 2) * size / 2 + size / 2
    trans = batch_orth_proj(verts, c["cam"])
    trans = torch.cat([trans[:, :, :1], -trans[:, :, 1:]], 2)
    screen = (trans[:, :, :2] + 1.0) * (size / 2.0)
    tri_id = raster.winners(screen, trans[:, :, 2], fl.faces, size, size)
    # per pixel: the winner's barycentrics at the pixel centre
    hit = (tri_id >= 0).reshape(bsz, -1)
    tri = tri_id.clamp(min=0).reshape(bsz, -1)
    p = screen.gather(1, fl.faces[tri].reshape(bsz, -1, 1).expand(
        -1, -1, 2)).view(bsz, -1, 3, 2)
    dev = codes.device
    qx = (torch.arange(size, device=dev, dtype=torch.float32) + 0.5).repeat(
        size)
    qy = (torch.arange(size, device=dev, dtype=torch.float32)
          + 0.5).repeat_interleave(size)
    w0, w1, w2, _ = raster.barycentrics(p[:, :, 0], p[:, :, 1], p[:, :, 2],
                                        qx, qy)
    bary = torch.stack([w0, w1, w2], -1) * hit[..., None]   # (B, P, 3)
    normals = vertex_normals(verts, fl.faces)
    face_n = normals.gather(1, fl.faces[tri].reshape(bsz, -1, 1).expand(
        -1, -1, 3)).view(bsz, -1, 3, 3)
    uvc = fl.uvcoords * 2 - 1
    uvc = torch.stack([uvc[:, 0], -uvc[:, 1]], 1)
    face_uv = uvc[fl.uvfaces[tri]]                          # (B, P, 3, 2)
    n_img = (bary[..., None] * face_n).sum(dim=-2) * hit[..., None]
    uv = (bary[..., None] * face_uv).sum(dim=-2) * hit[..., None]
    n_img = n_img.view(bsz, size, size, 3).permute(0, 3, 1, 2)
    grid = uv.view(bsz, size, size, 2)
    alb = F.grid_sample(albedo(c["tex"], fl, uv_size, precision), grid,
                        align_corners=False)
    shading = add_sh_light(n_img, c["light"].reshape(-1, 9, 3))
    alpha = hit.view(bsz, 1, size, size).to(torch.float32)
    image = (alb * shading * alpha).permute(0, 2, 3, 1)
    return Render(verts=verts, landmarks=lmk, bins=bins, tri_id=tri_id,
                  uv=grid, image=image)
