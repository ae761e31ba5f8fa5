"""DECA's detail decoder D_d (Feng et al., arXiv:2012.04012;
decalib/models/decoders.py `Generator(latent_dim=181, out_channels=1,
out_scale=0.01, sample_mode='bilinear')`). No twin in the JAX package.

The input is [jaw pose (3) | expression (50) | detail code (128)], 181
values; the output uv_z (B, 1, S, S), S = 32 x the start size (8 for
DECA's 256^2 UV maps):
  - Linear(181, 128 s^2), viewed as (128, s, s), BatchNorm2d(128) (eps
    1e-5);
  - five times Upsample(x2, bilinear, align_corners=False), Conv2d(3x3,
    pad 1), BatchNorm2d(c, 0.8), LeakyReLU(0.2): 128 -> 128 -> 64 -> 64
    -> 32 -> 16 channels. The 0.8 is the BatchNorms' eps, not a momentum
    (the second positional argument of BatchNorm2d), a quirk DECA took
    from a DCGAN template; it is kept;
  - Conv2d(16 -> 1, 3x3, pad 1), Tanh, x 0.01.

`DetailGenerator` is that module with DECA's layer names (`l1.0`,
`conv_blocks.<i>`), so DECA's D_detail state dict loads into it.
`FusedDetailGenerator.fold(gen)` is its inference form: every BatchNorm
folded from its running statistics, the first into the linear layer
(bilinear upsampling commutes with a per-channel affine map, its weights
summing to 1) and the others into the convolutions before them. Its
convolutions run in TF32 on the card (`tf32_convolutions`: cuDNN's
allow_tf32 on in the decoder's own scope, as DECA's released code runs
under PyTorch's default), the linear layer in float32; everything else
in the process stays as the pipeline sets it (TF32 off).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

# the channels after the linear layer and after each upsampling conv
CHANNELS = (128, 128, 64, 64, 32, 16)
BN0_EPS = 1e-5
BN_EPS = 0.8
SLOPE = 0.2
OUT_SCALE = 0.01
N_UP = 5


def latent_size(n_exp: int, n_detail: int) -> int:
    """[jaw 3 | exp | detail]: 181 for DECA's 50 and 128."""
    return 3 + n_exp + n_detail


def start_size(uv_size: int) -> int:
    if uv_size % (1 << N_UP):
        raise ValueError(f"uv_size {uv_size} is not a multiple of "
                         f"{1 << N_UP}")
    return uv_size >> N_UP


@contextlib.contextmanager
def tf32_convolutions():
    """cuDNN may compute float32 convolutions in TF32 inside the block;
    the previous setting comes back on leaving it."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


class DetailGenerator(nn.Module):
    """DECA's Generator as published (BatchNorm form, its layer names)."""

    def __init__(self, latent_dim: int = 181, uv_size: int = 256):
        super().__init__()
        self.init_size = start_size(uv_size)
        self.l1 = nn.Sequential(nn.Linear(latent_dim,
                                          CHANNELS[0] * self.init_size ** 2))
        layers: list = [nn.BatchNorm2d(CHANNELS[0], BN0_EPS)]
        for cin, cout in zip(CHANNELS[:-1], CHANNELS[1:]):
            layers += [nn.Upsample(scale_factor=2, mode="bilinear"),
                       nn.Conv2d(cin, cout, 3, stride=1, padding=1),
                       nn.BatchNorm2d(cout, BN_EPS),
                       nn.LeakyReLU(SLOPE, inplace=True)]
        layers += [nn.Conv2d(CHANNELS[-1], 1, 3, stride=1, padding=1),
                   nn.Tanh()]
        self.conv_blocks = nn.Sequential(*layers)

    def forward(self, z):
        out = self.l1(z).view(z.shape[0], CHANNELS[0], self.init_size,
                              self.init_size)
        return self.conv_blocks(out) * OUT_SCALE


def _affine(bn: nn.BatchNorm2d):
    """(scale, shift) of an eval-mode BatchNorm, float32."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


class FusedDetailGenerator(nn.Module):
    """The decoder for inference: BatchNorms folded (module docstring);
    the convolutions in TF32 on the card."""

    def __init__(self, latent_dim: int = 181, uv_size: int = 256):
        super().__init__()
        self.init_size = start_size(uv_size)
        self.l1 = nn.Linear(latent_dim, CHANNELS[0] * self.init_size ** 2)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1)
            for cin, cout in zip(CHANNELS[:-1], CHANNELS[1:]))
        self.out = nn.Conv2d(CHANNELS[-1], 1, 3, padding=1)

    @classmethod
    @torch.no_grad()
    def fold(cls, gen: DetailGenerator) -> "FusedDetailGenerator":
        """The eval-mode forward of `gen`, BatchNorms folded, on its
        device."""
        lin = gen.l1[0]
        fused = cls(lin.in_features, gen.init_size << N_UP).to(
            lin.weight.device)
        blocks = list(gen.conv_blocks)
        s, t = _affine(blocks[0])
        per = gen.init_size ** 2
        s, t = s.repeat_interleave(per), t.repeat_interleave(per)
        fused.l1.weight.copy_(lin.weight * s[:, None])
        fused.l1.bias.copy_(lin.bias * s + t)
        convs = [m for m in blocks if isinstance(m, nn.Conv2d)]
        bns = [m for m in blocks[1:] if isinstance(m, nn.BatchNorm2d)]
        for dst, conv, bn in zip(fused.convs, convs, bns):
            s, t = _affine(bn)
            dst.weight.copy_(conv.weight * s[:, None, None, None])
            dst.bias.copy_(conv.bias * s + t)
        fused.out.weight.copy_(convs[-1].weight)
        fused.out.bias.copy_(convs[-1].bias)
        return fused.eval()

    def forward(self, z):
        """z (B, latent) float32 -> uv_z (B, 1, S, S)."""
        x = self.l1(z).view(z.shape[0], CHANNELS[0], self.init_size,
                            self.init_size)
        with tf32_convolutions():
            for conv in self.convs:
                x = F.interpolate(x, scale_factor=2, mode="bilinear",
                                  align_corners=False)
                x = F.leaky_relu(conv(x), SLOPE, inplace=True)
            x = torch.tanh(self.out(x))
        return x * OUT_SCALE


def decoder_input(codes) -> torch.Tensor:
    """DECA's [pose[:, 3:] (jaw) | exp | detail] from DECACodes."""
    return torch.cat([codes.pose[:, 3:], codes.exp, codes.detail], dim=1)
