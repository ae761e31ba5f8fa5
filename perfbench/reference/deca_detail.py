"""DECA's detail forward (Feng, Feng, Black, Bolkart, SIGGRAPH 2021,
arXiv:2012.04012; github.com/yfeng95/DECA) from its codes, in plain
float32 PyTorch with TF32 off: the detail decoder (decalib/models/
decoders.py `Generator`), world2uv (utils/renderer.py), displacement2normal
(deca.py) over generate_triangles' dense grid with vertex_normals
(utils/util.py), add_SHlight, and the detailed image, F.grid_sample of
the shaded UV texture at the coarse render's UVs (DECA's
predicted_detailed_image). The coarse part is reference/deca.py's. It
imports nothing of the program.

codes (B, 364) = [shape 100 | tex 50 | exp 50 | pose 6 | cam 3 | light 27
| detail 128]:
  - uv_z = Generator([pose[:, 3:] | exp | detail]): Linear(181, 128 s^2),
    BatchNorm2d(128), then five times Upsample(x2, bilinear) (nn.Upsample,
    align_corners=False), Conv2d 3x3, BatchNorm2d(c, 0.8) (eps 0.8),
    LeakyReLU(0.2), over 128, 128, 64, 64, 32, 16 channels; Conv2d(16, 1),
    Tanh, x 0.01. BatchNorm in eval mode;
  - world2uv(x): the UV layout (uvcoords x 2 - 1, v negated, by uvfaces)
    rasterized at S x S, each texel the barycentric combination of the
    covering face's corner values (faces), 0 where no face covers it;
  - displacement2normal: uv_z M, P = V_uv + uv_z M N_uv + fixed N_uv
    (N_uv the world2uv of the coarse world vertex normals), the dense
    grid's vertex normals of P (vertex_normals: index_add_ of the corner
    cross products, `normal_sums`, then F.normalize), then normals M +
    N_uv (1 - M);
  - uv_texture = albedo x add_SHlight(detail normals, light);
    displacement_map = uv_z + fixed; the detailed image grid_sample(
    uv_texture, the coarse UVs) x coverage.

Departures from DECA's code, none of which changes the function at these
sizes:
  - world2uv is reference/raster.py's z-buffer, run on every call as
    DECA's does, at the texel centres F.grid_sample(align_corners=False)
    reads (texel (j, i) at ((2i + 1) / S - 1, (2j + 1) / S - 1)), which
    is where PyTorch3D's rasterizer, after DECA's negation of x and y,
    samples them; a centre on an edge is covered (PyTorch3D's test is
    strict), and between faces that both cover it, at DECA's constant UV
    depth, the lower face id wins (PyTorch3D's order decides in DECA);
  - the coarse part's departures (reference/deca.py), the image
    composited over zeros.

`precision` selects the control's arithmetic: "f32" is the reference;
"bf16" rounds every convolution's input and weight of the decoder to
bfloat16 (accumulating in float32), one precision below the TF32 the
configuration states for them."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import deca, raster

COARSE = sum(n for _, n in deca.SIZES)      # 236
CHANNELS = (128, 128, 64, 64, 32, 16)
MARGINS = (2, 5)


class Generator(nn.Module):
    """decoders.Generator(latent_dim, out_channels=1, out_scale=0.01,
    sample_mode='bilinear') as published, its start size init_size (8 for
    256^2 maps)."""

    def __init__(self, latent_dim=181, init_size=8, out_scale=0.01):
        super().__init__()
        self.out_scale = out_scale
        self.init_size = init_size
        self.l1 = nn.Sequential(nn.Linear(latent_dim,
                                          128 * self.init_size ** 2))
        self.conv_blocks = nn.Sequential(
            nn.BatchNorm2d(128),
            nn.Upsample(scale_factor=2, mode="bilinear"),
            nn.Conv2d(128, 128, 3, stride=1, padding=1),
            nn.BatchNorm2d(128, 0.8),
            nn.LeakyReLU(0.2, inplace=True),
            nn.Upsample(scale_factor=2, mode="bilinear"),
            nn.Conv2d(128, 64, 3, stride=1, padding=1),
            nn.BatchNorm2d(64, 0.8),
            nn.LeakyReLU(0.2, inplace=True),
            nn.Upsample(scale_factor=2, mode="bilinear"),
            nn.Conv2d(64, 64, 3, stride=1, padding=1),
            nn.BatchNorm2d(64, 0.8),
            nn.LeakyReLU(0.2, inplace=True),
            nn.Upsample(scale_factor=2, mode="bilinear"),
            nn.Conv2d(64, 32, 3, stride=1, padding=1),
            nn.BatchNorm2d(32, 0.8),
            nn.LeakyReLU(0.2, inplace=True),
            nn.Upsample(scale_factor=2, mode="bilinear"),
            nn.Conv2d(32, 16, 3, stride=1, padding=1),
            nn.BatchNorm2d(16, 0.8),
            nn.LeakyReLU(0.2, inplace=True),
            nn.Conv2d(16, 1, 3, stride=1, padding=1),
            nn.Tanh(),
        )

    def forward(self, noise, precision: str = "f32"):
        out = self.l1(noise)
        out = out.view(out.shape[0], 128, self.init_size, self.init_size)
        if precision == "f32":
            img = self.conv_blocks(out)
        else:
            img = out
            for m in self.conv_blocks:
                if isinstance(m, nn.Conv2d):
                    img = F.conv2d(_bf16(img), _bf16(m.weight), m.bias,
                                   padding=1)
                else:
                    img = m(img)
        return img * self.out_scale


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


class Detail(NamedTuple):
    """The detail model's arrays on one device."""
    generator: Generator
    fixed_uv_dis: torch.Tensor      # (S, S)
    uv_face_eye_mask: torch.Tensor  # (S, S)
    dense_faces: torch.Tensor       # (F_d, 3) int64


def generate_triangles(h, w, margin_x=2, margin_y=5):
    """util.generate_triangles, as DECA writes it."""
    triangles = []
    for x in range(margin_x, w - 1 - margin_x):
        for y in range(margin_y, h - 1 - margin_y):
            triangle0 = [y * w + x, y * w + x + 1, (y + 1) * w + x]
            triangle1 = [y * w + x + 1, (y + 1) * w + x + 1, (y + 1) * w + x]
            triangles.append(triangle0)
            triangles.append(triangle1)
    triangles = torch.tensor(triangles, dtype=torch.int64)
    return triangles[:, [0, 2, 1]]


def detail_on(state: dict, fixed_uv_dis, uv_face_eye_mask, latent_dim: int,
              device) -> Detail:
    """The reference's detail model from a Generator state dict (DECA's
    names) and the two arrays."""
    size = int(fixed_uv_dis.shape[0])
    gen = Generator(latent_dim, size // 32).to(device)
    gen.load_state_dict(state)
    return Detail(gen.eval(),
                  torch.as_tensor(fixed_uv_dis, dtype=torch.float32).to(
                      device),
                  torch.as_tensor(uv_face_eye_mask, dtype=torch.float32).to(
                      device),
                  generate_triangles(size, size, *MARGINS).to(device))


def uv_rasterize(fl: deca.Flame, size: int):
    """(face (S * S,) int64, -1 where none; barycentrics (S * S, 3)): the
    UV layout's z-buffer at the texel centres, ties to the lower face."""
    uv = fl.uvcoords
    screen = torch.stack([uv[:, 0] * size, (1.0 - uv[:, 1]) * size], -1)
    face = raster.winners(screen[None], torch.zeros_like(screen[None, :, 0]),
                          fl.uvfaces, size, size)[0].reshape(-1)
    p = screen[fl.uvfaces[face.clamp(min=0)]]                 # (T, 3, 2)
    dev = uv.device
    qx = (torch.arange(size, device=dev, dtype=torch.float32) + 0.5).repeat(
        size)
    qy = (torch.arange(size, device=dev, dtype=torch.float32)
          + 0.5).repeat_interleave(size)
    w0, w1, w2, _ = raster.barycentrics(p[:, 0], p[:, 1], p[:, 2], qx, qy)
    bary = torch.stack([w0, w1, w2], -1) * (face >= 0)[:, None]
    return face, bary


def world2uv(attrs, fl: deca.Flame, size: int):
    """attrs (B, N, 3) -> (B, 3, S, S), rasterized anew on every call."""
    face, bary = uv_rasterize(fl, size)
    bsz = attrs.shape[0]
    vid = fl.faces[face.clamp(min=0)]                         # (T, 3)
    corners = attrs[:, vid]                                   # (B, T, 3, 3)
    vals = (bary[None, :, :, None] * corners).sum(dim=-2)
    vals = vals * (face >= 0)[None, :, None]
    return vals.permute(0, 2, 1).reshape(bsz, 3, size, size)


def normal_sums(vertices, faces):
    """util.vertex_normals before its F.normalize: each vertex's sum of
    its faces' corner cross products, by index_add_ as DECA writes it."""
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
    return normals.reshape((bs, nv, 3))


def displacement2normal(uv_z, coarse_verts, coarse_normals, fl, det: Detail):
    """deca.DECA.displacement2normal: ((B, 3, S, S) detail normals, (B, S,
    S) the length of each dense normal before normalisation, which is
    near zero where the displaced surface folds)."""
    bsz = uv_z.shape[0]
    size = det.fixed_uv_dis.shape[0]
    uv_coarse_vertices = world2uv(coarse_verts, fl, size)
    uv_coarse_normals = world2uv(coarse_normals, fl, size)
    uv_z = uv_z * det.uv_face_eye_mask
    uv_detail_vertices = (uv_coarse_vertices + uv_z * uv_coarse_normals
                          + det.fixed_uv_dis[None, None] * uv_coarse_normals)
    dense_vertices = uv_detail_vertices.permute(0, 2, 3, 1).reshape(
        [bsz, -1, 3])
    sums = normal_sums(dense_vertices, det.dense_faces)
    uv_detail_normals = F.normalize(sums, eps=1e-6, dim=2)
    uv_detail_normals = uv_detail_normals.reshape(
        [bsz, size, size, 3]).permute(0, 3, 1, 2)
    return (uv_detail_normals * det.uv_face_eye_mask
            + uv_coarse_normals * (1 - det.uv_face_eye_mask),
            torch.linalg.vector_norm(sums, dim=2).view(bsz, size, size))


class DetailRender(NamedTuple):
    coarse: deca.Render           # verts, landmarks, bins, tri_id, uv
    uv_z: torch.Tensor            # (B, S, S) the decoder's output
    displacement: torch.Tensor    # (B, S, S) uv_z + fixed
    normals: torch.Tensor         # (B, S, S, 3) uv_detail_normals
    normal_length: torch.Tensor   # (B, S, S) dense normals' length
                                  # before normalisation
    image: torch.Tensor           # (B, H, W, 3) the detailed image


def render(codes, fl: deca.Flame, det: Detail, size: int,
           precision: str = "f32") -> DetailRender:
    """DECA's detail forward from codes (B, 236 + n_detail) at size x
    size px (the module docstring)."""
    uv_size = det.fixed_uv_dis.shape[0]
    coarse = deca.render(codes[:, :COARSE], fl, size, uv_size)
    c = deca.split(codes[:, :COARSE])
    bsz = codes.shape[0]
    uv_z = det.generator(torch.cat([c["pose"][:, 3:], c["exp"],
                                    codes[:, COARSE:]], 1), precision)
    normals = deca.vertex_normals(coarse.verts, fl.faces)
    uv_detail_normals, length = displacement2normal(uv_z, coarse.verts,
                                                    normals, fl, det)
    uv_shading = deca.add_sh_light(uv_detail_normals,
                                   c["light"].reshape(-1, 9, 3))
    uv_texture = deca.albedo(c["tex"], fl, uv_size) * uv_shading
    alpha = (coarse.tri_id >= 0).view(bsz, 1, size, size).to(torch.float32)
    image = F.grid_sample(uv_texture, coarse.uv, align_corners=False) * alpha
    return DetailRender(coarse=coarse, uv_z=uv_z[:, 0],
                        displacement=(uv_z + det.fixed_uv_dis)[:, 0],
                        normals=uv_detail_normals.permute(0, 2, 3, 1),
                        normal_length=length, image=image.permute(0, 2, 3, 1))
