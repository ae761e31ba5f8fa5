"""CNN 3DMM-coefficient regressor for training (twin of
facerecon_tpu/models/resnet.py).

ResNet-50-style backbone with BatchNorm and a dense head emitting the
concatenated coefficient vector:
  - parameters are float32; convolutions compute in the model dtype
    (bf16 by default) in channels_last layout, with the weights cast at
    each call, as flax's `dtype=` does;
  - BatchNorm follows flax, not torch: batch statistics in float32 with
    input and output in the model dtype, normalisation and the running
    variance both with the BIASED variance, running = 0.9 running + 0.1
    batch (flax `momentum=0.9`);
  - flax's SAME padding (asymmetric at stride 2) is explicit, as in
    models/fused.py;
  - the head is zero-initialised, so an untrained net predicts the mean
    face (all-zero coefficients), the stable self-supervised start;
  - `hidden` > 0 puts a float32 hidden layer and a ReLU before the head
    (DECA's encoder: Linear(2048, 1024), ReLU, Linear(1024, 236)). The
    backbone keeps flax's SAME padding, where DECA's torchvision ResNet-50
    pads symmetrically (3 for the 7x7 stem, 1 for the 3x3s and the pool).

The public input is NHWC (B, H, W, 3) float32 in [0,1], as in the
reference. Carry the reference's variables over with
`jax_params.train_state_dict`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from facerecon_tpu_torch.config import FaceReconConfig, is_flame
from facerecon_tpu_torch.models.fused import STAGES, _same_pads
from facerecon_tpu_torch.parallel import mesh

_MOMENTUM = 0.9
_EPS = 1e-5


def _conv(conv: nn.Conv2d, x):
    """conv (no bias, float32 weight) with flax SAME padding, computed in
    x's dtype."""
    k, s = conv.kernel_size[0], conv.stride[0]
    (t, b), (l, r) = (_same_pads(x.shape[2], k, s),
                      _same_pads(x.shape[3], k, s))
    if (t, b, l, r) != (0, 0, 0, 0):
        x = F.pad(x, (l, r, t, b))
    return F.conv2d(x, conv.weight.to(x.dtype), None, s)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5) over NCHW's C."""

    def __init__(self, channels: int, zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,),
                                              0.0 if zero_scale else 1.0))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, _EPS)
        if mesh.world() > 1:
            return self._forward_global(x)
        # one pass: normalise with the batch's biased variance (float32
        # inside, x's dtype out); with momentum 1 the buffers receive the
        # batch mean and the UNBIASED variance, rescaled to flax's biased
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         _EPS)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(_MOMENTUM).add_(mean, alpha=1 - _MOMENTUM)
            self.running_var.mul_(_MOMENTUM).add_(
                var, alpha=(1 - _MOMENTUM) * (n - 1) / n)
        return y

    def _forward_global(self, x):
        """Train mode under data parallelism: the moments of the GLOBAL
        batch, as the reference's BatchNorm computes them inside a step
        jitted over the mesh. Each rank's per-channel sum and sum of
        squares (float32) are all-reduced, differentiably, so the
        backward also sees the global statistics; normalisation and the
        running variance use the global biased variance, and the count
        is the global one."""
        c = x.shape[1]
        xf = x.float()
        stats = mesh.all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)),
                                           (xf * xf).sum(dim=(0, 2, 3))]))
        n = x.numel() // c * mesh.world()
        mean = stats[:c] / n
        var = torch.clamp(stats[c:] / n - mean * mean, min=0.0)
        scale = self.weight * torch.rsqrt(var + _EPS)
        shift = self.bias - mean * scale
        y = xf * scale[:, None, None] + shift[:, None, None]
        with torch.no_grad():
            self.running_mean.mul_(_MOMENTUM).add_(mean, alpha=1 - _MOMENTUM)
            self.running_var.mul_(_MOMENTUM).add_(var, alpha=1 - _MOMENTUM)
        return y.to(x.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn0 = BatchNorm(features)
        self.conv1 = nn.Conv2d(features, features, 3, stride=strides,
                               bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn2 = BatchNorm(features * 4, zero_scale=True)
        # residual projection where the shapes differ (flax Conv_3)
        if in_ch != features * 4 or strides != 1:
            self.proj = nn.Conv2d(in_ch, features * 4, 1, stride=strides,
                                  bias=False)
            self.proj_bn = BatchNorm(features * 4)
        else:
            self.proj = None

    def forward(self, x):
        y = F.relu(self.bn0(_conv(self.conv0, x)))
        y = F.relu(self.bn1(_conv(self.conv1, y)))
        y = self.bn2(_conv(self.conv2, y))
        residual = (x if self.proj is None
                    else self.proj_bn(_conv(self.proj, x)))
        return F.relu(y + residual)


class ResNetRegressor(nn.Module):
    """ResNet backbone (BatchNorm) -> global pool -> dense coeff head."""

    def __init__(self, n_coeff: int,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, dtype=torch.bfloat16, hidden: int = 0):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes, self.width = tuple(stage_sizes), width
        self.stem = nn.Conv2d(3, width, 7, stride=2, bias=False)
        self.stem_bn = BatchNorm(width)
        blocks, in_ch = [], width
        for i, n_blocks in enumerate(stage_sizes):
            for k in range(n_blocks):
                strides = 2 if (i > 0 and k == 0) else 1
                blocks.append(BottleneckBlock(in_ch, width * 2 ** i,
                                              strides))
                in_ch = width * 2 ** i * 4
        self.blocks = nn.ModuleList(blocks)
        self.head_hidden = nn.Linear(in_ch, hidden) if hidden else None
        self.head = nn.Linear(hidden or in_ch, n_coeff)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, images):
        """images (B,H,W,3) float32 in [0,1] -> coeffs (B,n_coeff) f32."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(_conv(self.stem, x)))
        (t, bo), (l, r) = (_same_pads(x.shape[2], 3, 2),
                           _same_pads(x.shape[3], 3, 2))
        x = F.max_pool2d(F.pad(x, (l, r, t, bo), value=-math.inf), 3, 2)
        for blk in self.blocks:
            x = blk(x)
        x = x.mean(dim=(2, 3)).to(torch.float32)
        if self.head_hidden is not None:
            x = F.relu(self.head_hidden(x))
        return self.head(x)

    @torch.no_grad()
    def reset_parameters_(self, generator: torch.Generator):
        """The reference's initialisation from `generator` (a CPU
        generator): LeCun-normal (truncated at 2 std) convs and hidden
        layer, unit BN scales (zero for each block's last BN), zero
        biases and head, unit running statistics."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d) or mod is self.head_hidden:
                fan_in = mod.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        for blk in self.blocks:
            blk.bn2.weight.zero_()
        self.head.weight.zero_()
        self.head.bias.zero_()
        return self


def build_model(cfg: FaceReconConfig, depth: int = 50,
                dtype=torch.bfloat16, n_out: int = 0) -> ResNetRegressor:
    """The regressor of cfg's codes, or of n_out values (DECA's detail
    encoder: n_out = cfg.n_detail) where n_out > 0."""
    n = n_out or (cfg.n_coarse if is_flame(cfg) else cfg.n_coeff)
    return ResNetRegressor(n_coeff=n, stage_sizes=STAGES[depth], dtype=dtype,
                           hidden=cfg.head_hidden if is_flame(cfg) else 0)
