"""The work each measured function needs, counted from the cell's
shapes and inputs, whatever implements it, and the H100's data-sheet
peaks it is divided by.

- ResNet-50 (`cnn_flops`): 2 FLOPs a multiply-add of every convolution
  at the shapes the configuration states (the 7x7 stride-2 stem on 3
  channels, SAME padding) and of the head; computed in bf16.
- The 3DMM basis products (`basis_flops`): 3N x (K_id + K_exp + K_tex)
  multiply-adds a face, in float32.
- The rasterizers (`raster_work`): bytes read once and written once, and
  the float32 ops of the pixel-triangle tests the inputs need
  (`needed_tests`: the pixel centres inside each triangle's bounding box,
  7 ops a test plus 4 for each pixel column and row of the box).
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 outside
# them, HBM3 bandwidth (at the card's 700 W power limit)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

TEST_OPS = 7
AXIS_OPS = 4


def cnn_flops(image_size: int, n_coeff: int, stages=(3, 4, 6, 3),
              width: int = 64) -> int:
    """FLOPs of one image's forward through ResNet-50 and the head."""
    macs = 0
    h = -(-image_size // 2)                       # stem, stride 2
    macs += h * h * width * 3 * 49
    h = -(-h // 2)                                # max-pool, stride 2
    in_ch = width
    for i, n_blocks in enumerate(stages):
        feat = width * 2 ** i
        for j in range(n_blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            out = -(-h // stride)
            macs += h * h * feat * in_ch             # conv0, 1x1
            macs += out * out * feat * feat * 9      # conv1, 3x3
            macs += out * out * feat * 4 * feat      # conv2, 1x1
            if in_ch != feat * 4 or stride != 1:
                macs += out * out * feat * 4 * in_ch  # projection
            in_ch, h = feat * 4, out
    macs += in_ch * n_coeff
    return 2 * macs


def basis_flops(n_vertices: int, sizes: dict) -> int:
    return 2 * 3 * n_vertices * (sizes["n_id"] + sizes["n_exp"]
                                 + sizes["n_tex"])


def least_seconds_per_face(cfgf: dict, n_vertices: int, with_cnn: bool,
                           train: bool) -> float:
    """Each precision's FLOPs over its peak, summed; x 3 for a step."""
    sizes = cfgf["sizes"]
    t = basis_flops(n_vertices, sizes) / PEAK_F32
    if with_cnn:
        bb = cfgf["backbone"]
        t += cnn_flops(cfgf["camera"]["image_size"],
                       sum(sizes[k] for k in ("n_id", "n_exp", "n_tex",
                                              "n_angles", "n_gamma",
                                              "n_trans")),
                       tuple(bb["stages"]), bb["width"]) / PEAK_BF16
    return 3 * t if train else t


def needed_tests(screen, faces, height: int, width: int):
    """(tests, f32 ops) of one batch: screen (B, N, 2) pixel positions,
    faces (F, 3). A triangle of no area needs none."""
    p = screen[:, faces].double()                 # (B, F, 3, 2)
    area = ((p[..., 1, 0] - p[..., 0, 0]) * (p[..., 2, 1] - p[..., 0, 1])
            - (p[..., 1, 1] - p[..., 0, 1]) * (p[..., 2, 0] - p[..., 0, 0]))

    def centres(lo, hi, size):
        first = torch.clamp(torch.ceil(lo - 0.5), min=0)
        last = torch.clamp(torch.floor(hi - 0.5), max=size - 1)
        return torch.clamp(last - first + 1, min=0).nan_to_num(0.0)
    live = area.abs() > 1e-12
    nx = centres(p[..., 0].amin(-1), p[..., 0].amax(-1), width) * live
    ny = centres(p[..., 1].amin(-1), p[..., 1].amax(-1), height) * live
    some = (nx * ny) > 0
    tests = int((nx * ny).sum())
    return tests, TEST_OPS * tests + AXIS_OPS * int(((nx + ny) * some).sum())


def raster_work(kernel: str, screen, faces, n_vertices: int,
                height: int, width: int):
    """(bytes, f32 ops) of one launch over a batch, by what the function
    reads and writes:
      shade  (K1): per image the vertices' screen position and depth and
             radiance (24 B a vertex), the face list once (12 B a face),
             per pixel the winner id, colour and barycentrics (28 B);
      select (K2): per image positions and depth and radiance (24 B a
             vertex), the skin weights and face list once, per pixel the
             winner id and its 20 record values (84 B);
      grad   (K3): per pixel the 17 differentiable values' cotangents and
             the winner id (72 B), per face the 17 gradients (68 B).
    Ops: the needed tests of K1 and K2 (K3 has no test)."""
    bsz = screen.shape[0]
    n_faces = faces.shape[0]
    px = height * width
    if kernel == "grad":
        return bsz * (px * 72 + n_faces * 68), 0
    _, ops = needed_tests(screen, faces, height, width)
    if kernel == "shade":
        nbytes = bsz * (n_vertices * 24 + px * 28) + n_faces * 12
    elif kernel == "select":
        nbytes = (bsz * (n_vertices * 24 + px * 84)
                  + n_vertices * 4 + n_faces * 12)
    else:
        raise ValueError(kernel)
    return nbytes, ops


def bound_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


