"""SH-9 Lambertian illumination (twin of facerecon_tpu/ops/sh.py).

Radiance per channel k: C_k = T_k * (Y(n) . (gamma_k + e1)), where Y(n) is
the 9-dim SH basis of the vertex normal and e1 adds 1 to the DC term.
"""

from __future__ import annotations

import numpy as np
import torch

_A0 = np.pi
_A1 = 2.0 * np.pi / np.sqrt(3.0)
_A2 = 2.0 * np.pi / np.sqrt(8.0)
_C0 = 1.0 / np.sqrt(4.0 * np.pi)
_C1 = np.sqrt(3.0) / np.sqrt(4.0 * np.pi)
_C2 = 3.0 * np.sqrt(5.0) / np.sqrt(12.0 * np.pi)

# the 9 scale constants, DC first
SH_SCALES = np.array([
    _A0 * _C0,
    -_A1 * _C1, _A1 * _C1, -_A1 * _C1,
    _A2 * _C2, -_A2 * _C2, _A2 * _C2 / (2.0 * np.sqrt(3.0)),
    -_A2 * _C2, _A2 * _C2 / 2.0,
], dtype=np.float32)


def illuminate(texture: torch.Tensor, normals: torch.Tensor,
               gamma: torch.Tensor) -> torch.Tensor:
    """Per-vertex radiance.

    texture (B,N,3) albedo in [0,1]; normals (B,N,3); gamma (B,27).
    Returns (B,N,3) radiance (unclamped; compositing clips for display).
    Nine broadcast multiply-adds per channel, in the reference's order.
    """
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    feats = (None, ny, nz, nx, nx * ny, ny * nz, 3.0 * nz * nz - 1.0,
             nx * nz, nx * nx - ny * ny)        # index 0 is the constant 1
    dc = torch.zeros(9, dtype=gamma.dtype, device=gamma.device)
    dc[0] = 1.0                                 # ambient init on DC term
    scales = torch.as_tensor(SH_SCALES, device=gamma.device)
    g = (gamma.reshape(*gamma.shape[:-1], 3, 9) + dc) * scales   # (B,3,9)
    chans = []
    for c in range(3):
        gc = g[..., c, :]                       # (B,9)
        light = gc[..., 0:1]                    # (B,1) broadcast over N
        for k in range(1, 9):
            light = light + feats[k] * gc[..., k:k + 1]
        chans.append(texture[..., c] * light)
    return torch.stack(chans, dim=-1)
