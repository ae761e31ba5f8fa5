"""Seeded stand-ins for DECA's detail model at the published sizes
(arXiv:2012.04012: data/fixed_displacement_256.npy,
data/uv_face_eye_mask.png, and D_detail's weights in deca_model.tar),
none of which is in the repository.

`detail_arrays(arrays, uv_size, seed)`, on flame_data.flame_arrays'
head:
  fixed_uv_dis (S, S)      a smooth field over the whole UV square: 32
                           Gaussian bumps of width S / 12 texels with
                           normal weights, scaled to 1 mm RMS over the
                           texels (DECA's fixed displacement is added
                           unmasked, along the coarse normal)
  uv_face_eye_mask (S, S)  1 on the face, 0 elsewhere: the texels whose
                           point on the template (world2uv of the
                           template's vertices, reference/deca_detail.py)
                           lies on the front (z > FRONT_Z m), between chin
                           and brow line (Y_RANGE, flame_data's landmark
                           band), and outside two eye discs of radius
                           EYE_RADIUS m in the x-y plane around
                           flame_data's eye joints; texels no UV face
                           covers are 0

`decoder_state(seed, latent_dim, uv_size, calib, device)`: the
Generator's state dict (DECA's names) from the seed: linear and
convolution weights normal at 1 / sqrt(fan in), biases N(0, 0.1),
BatchNorm scales U(0.8, 1.2) and shifts N(0, 0.1); then, layer by layer
on the calibration batch of decoder inputs `calib`, each convolution's
output channels rescaled to unit variance and each BatchNorm's running
mean and variance set to the batch's, so each pre-activation is near
unit scale (the 0.8 eps then matters: a fault that drops it shows), and
the last convolution scaled so the tanh's input has std TANH_STD over
the batch (the tanh neither saturated nor flat).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from perfbench import flame_data
from perfbench.reference import deca, deca_detail

FIXED_RMS_M = 1e-3
FRONT_Z = 0.035
Y_RANGE = (-0.075, 0.055)
EYE_RADIUS = 0.012
TANH_STD = 0.5


def detail_arrays(arrays: dict, uv_size: int, seed: int) -> dict:
    """{"fixed_uv_dis", "uv_face_eye_mask"}, float32 (S, S)."""
    rng = np.random.default_rng([seed, 26])
    s = uv_size
    yy, xx = np.meshgrid(np.arange(s) + 0.5, np.arange(s) + 0.5,
                         indexing="ij")
    centres = rng.uniform(0, s, (32, 2))
    weights = rng.standard_normal(32)
    width = s / 12.0
    field = sum(w * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                           / (2 * width ** 2))
                for w, (cx, cy) in zip(weights, centres))
    fixed = field * FIXED_RMS_M / np.sqrt((field ** 2).mean())
    fl = deca.flame_on(arrays, "cpu")
    face, _ = deca_detail.uv_rasterize(fl, s)
    p = deca_detail.world2uv(fl.v_template[None], fl, s)[0].permute(
        1, 2, 0).numpy()
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    mask = (z > FRONT_Z) & (y > Y_RANGE[0]) & (y < Y_RANGE[1])
    for eye in flame_data._JOINTS[3:]:
        mask &= (x - eye[0]) ** 2 + (y - eye[1]) ** 2 > EYE_RADIUS ** 2
    mask &= (face >= 0).reshape(s, s).numpy()
    return {"fixed_uv_dis": fixed.astype(np.float32),
            "uv_face_eye_mask": mask.astype(np.float32)}


@torch.no_grad()
def decoder_state(seed: int, latent_dim: int, uv_size: int, calib,
                  device) -> dict:
    """The calibrated Generator state dict (module docstring); calib
    (C, latent_dim) on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + 26) % (1 << 63))
    gen = deca_detail.Generator(latent_dim, uv_size // 32).to(device)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device) * std
    for m in gen.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.copy_(normal(m.weight.shape,
                                  1.0 / m.weight[0].numel() ** 0.5))
            m.bias.copy_(normal(m.bias.shape, 0.1))
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.copy_(torch.rand(m.weight.shape, generator=g,
                                      device=device) * 0.4 + 0.8)
            m.bias.copy_(normal(m.bias.shape, 0.1))
    gen.eval()
    x = gen.l1(calib).view(calib.shape[0], 128, gen.init_size,
                           gen.init_size)
    layers = list(gen.conv_blocks)
    convs = [m for m in layers if isinstance(m, nn.Conv2d)]
    for i, m in enumerate(layers):
        if isinstance(m, nn.Conv2d):
            y = m(x)
            if m is convs[-1]:
                k = TANH_STD / float(y.std())
            else:
                k = 1.0 / y.std(dim=(0, 2, 3)).clamp(min=1e-12)
            k = torch.as_tensor(k, device=device).reshape(-1)
            m.weight.mul_(k.reshape(-1, 1, 1, 1))
            m.bias.mul_(k)
        elif isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(x.mean(dim=(0, 2, 3)))
            m.running_var.copy_(x.var(dim=(0, 2, 3)))
        x = m(x)
    return {k: v.detach().clone() for k, v in gen.state_dict().items()}
