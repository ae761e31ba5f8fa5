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
summing to 1) and the others into the convolutions before them; the
linear layer's rows permuted to emit NHWC and the convolutions' weights
laid out by tap. On the card its forward is the linear layer in float32
(one addmm, TF32 off as the pipeline sets it) and the hand-written
kernels of csrc/upconv.cu: per layer one `upconv` launch (the x2
bilinear upsampling fused into the 3x3 convolution's input gather, TF32
operands with float32 accumulation, bias and LeakyReLU in its epilogue,
NHWC; no upsampled tensor is written), then one `outconv` launch (the
last convolution in float32, tanh, the scale). `forward_reference` is
the plain version: the eager ops, cuDNN's convolutions in TF32 on the
card (`tf32_convolutions`: allow_tf32 on in the decoder's own scope, as
DECA's released code runs under PyTorch's default); `upsample_reference`
is the kernel's interpolation op for op.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from facerecon_tpu_torch.ops import _build

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
    """The decoder for inference: BatchNorms folded (module docstring),
    laid out for the kernels: the linear layer's rows in (y, x, channel)
    order, so that it emits NHWC (B, s, s, 128), and each convolution's
    weights by tap, `conv_w[i]` (9, Cout, Cin) and `out_w` (9, 16), tap
    ky * 3 + kx. On CUDA tensors `forward` is the linear layer (one
    float32 addmm), five `upconv` launches and one `outconv` launch
    (csrc/upconv.cu); on CPU tensors it is `forward_reference`."""

    def __init__(self, latent_dim: int = 181, uv_size: int = 256):
        super().__init__()
        self.init_size = start_size(uv_size)
        self.l1 = nn.Linear(latent_dim, CHANNELS[0] * self.init_size ** 2)
        self.conv_w = nn.ParameterList(
            torch.empty(9, cout, cin)
            for cin, cout in zip(CHANNELS[:-1], CHANNELS[1:]))
        self.conv_b = nn.ParameterList(torch.empty(c) for c in CHANNELS[1:])
        self.out_w = nn.Parameter(torch.empty(9, CHANNELS[-1]))
        self.out_b = nn.Parameter(torch.empty(1))

    @classmethod
    @torch.no_grad()
    def fold(cls, gen: DetailGenerator) -> "FusedDetailGenerator":
        """The eval-mode forward of `gen`, BatchNorms folded, on its
        device."""
        lin = gen.l1[0]
        s0 = gen.init_size
        fused = cls(lin.in_features, s0 << N_UP).to(lin.weight.device)
        blocks = list(gen.conv_blocks)
        s, t = _affine(blocks[0])
        per = s0 ** 2
        s, t = s.repeat_interleave(per), t.repeat_interleave(per)
        # rows (c, y, x) -> (y, x, c)
        rows = torch.arange(CHANNELS[0] * per, device=lin.weight.device
                            ).view(CHANNELS[0], s0, s0).permute(1, 2, 0)
        rows = rows.reshape(-1)
        fused.l1.weight.copy_((lin.weight * s[:, None])[rows])
        fused.l1.bias.copy_((lin.bias * s + t)[rows])
        convs = [m for m in blocks if isinstance(m, nn.Conv2d)]
        bns = [m for m in blocks[1:] if isinstance(m, nn.BatchNorm2d)]
        for w, b, conv, bn in zip(fused.conv_w, fused.conv_b, convs, bns):
            s, t = _affine(bn)
            w.copy_(by_tap(conv.weight * s[:, None, None, None]))
            b.copy_(conv.bias * s + t)
        fused.out_w.copy_(by_tap(convs[-1].weight)[:, 0])
        fused.out_b.copy_(convs[-1].bias)
        return fused.eval()

    def forward(self, z):
        """z (B, latent) float32 -> uv_z (B, 1, S, S)."""
        if not _build.on_card(z.device):
            return self.forward_reference(z)
        s = self.init_size
        x = self.l1(z).view(z.shape[0], s, s, CHANNELS[0])
        for w, b in zip(self.conv_w, self.conv_b):
            x = upconv(x, w, b)
        return outconv(x, self.out_w, self.out_b)

    def forward_reference(self, z):
        """Plain PyTorch version of the kernels' decoder on the same
        parameters, NCHW: the linear layer, then F.interpolate, conv2d
        and LeakyReLU five times, the last conv2d, tanh and the scale,
        with cuDNN in TF32 on the card."""
        s = self.init_size
        x = self.l1(z).view(z.shape[0], s, s, CHANNELS[0]).permute(
            0, 3, 1, 2).contiguous()
        with tf32_convolutions():
            for w, b in zip(self.conv_w, self.conv_b):
                x = _upconv_nchw(x, w, b)
            return _outconv_nchw(x, self.out_w, self.out_b)


# (cin, cout) of each layer csrc/upconv.cu has a tiling for: DECA's five
UPCONV_LAYERS = tuple(zip(CHANNELS[:-1], CHANNELS[1:]))


def _upconv_nchw(x, w, b):
    x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    return F.leaky_relu(F.conv2d(x, oihw(w), b, padding=1), SLOPE,
                        inplace=True)


def _outconv_nchw(x, w, b):
    return torch.tanh(F.conv2d(x, oihw(w[:, None]), b, padding=1)) * OUT_SCALE


def upconv(x, w, b):
    """LeakyReLU(conv3x3_pad1(upsample_bilinear_x2(x)) + b): x (B, s, s,
    Cin), w (9, Cout, Cin) by tap, b (Cout,) -> (B, 2s, 2s, Cout), NHWC
    float32, (Cin, Cout) one of UPCONV_LAYERS. CUDA tensors launch the
    kernel (TF32 operands, float32 accumulation); CPU tensors take
    `upconv_reference`."""
    bsz, s = x.shape[:2]
    cout, cin = w.shape[1:]
    if (cin, cout) not in UPCONV_LAYERS:
        raise ValueError(f"upconv has no tiling for {cin} -> {cout} "
                         f"channels (it takes {UPCONV_LAYERS})")
    if not _build.on_card(x.device):
        return upconv_reference(x, w, b)
    y = x.new_empty((bsz, 2 * s, 2 * s, cout))
    _build.check_tensors(x.device, {
        "x": (x, torch.float32, (bsz, s, s, cin)),
        "w": (w, torch.float32, (9, cout, cin)),
        "b": (b, torch.float32, (cout,))})
    _aligned(x, w, b, y)
    if bsz > 65535:
        raise ValueError(f"upconv takes at most 65535 images, got {bsz}")
    if bsz:
        _build.launch("upconv", x.device, (x, w, b, y), (bsz, s, cin, cout),
                      floats=(SLOPE,))
    return y


def _aligned(*tensors):
    """The kernels read and write 16 bytes at a time."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the decoder's kernels need 16-byte aligned "
                             "tensors")


def upconv_reference(x, w, b):
    """Plain PyTorch version of `upconv` (the eager ops, cuDNN in TF32 on
    the card), NHWC in and out: on the card the channels_last tensors
    take cuDNN's NHWC convolutions."""
    with tf32_convolutions():
        return _upconv_nchw(x.permute(0, 3, 1, 2), w, b).permute(0, 2, 3, 1)


def outconv(x, w, b):
    """tanh(conv3x3_pad1(x) + b) x OUT_SCALE: x (B, S, S, 16) NHWC, w
    (9, 16) by tap, b (1,) -> uv_z (B, 1, S, S), float32. CUDA tensors
    launch the kernel (float32); CPU tensors take `outconv_reference`."""
    if not _build.on_card(x.device):
        return outconv_reference(x, w, b)
    bsz, s = x.shape[:2]
    _build.check_tensors(x.device, {
        "x": (x, torch.float32, (bsz, s, s, CHANNELS[-1])),
        "w": (w, torch.float32, (9, CHANNELS[-1])),
        "b": (b, torch.float32, (1,))})
    _aligned(x)
    if bsz > 65535:
        raise ValueError(f"outconv takes at most 65535 images, got {bsz}")
    out = x.new_empty((bsz, 1, s, s))
    if bsz:
        _build.launch("outconv", x.device, (x, w, b, out), (bsz, s),
                      floats=(OUT_SCALE,))
    return out


def outconv_reference(x, w, b):
    """Plain PyTorch version of `outconv`, NHWC in."""
    with tf32_convolutions():
        return _outconv_nchw(x.permute(0, 3, 1, 2), w, b)


def by_tap(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> by tap (9, Cout, Cin), tap ky * 3 + kx."""
    return w.permute(2, 3, 0, 1).reshape(9, *w.shape[:2])


def oihw(w: torch.Tensor) -> torch.Tensor:
    """By tap (9, Cout, Cin) -> OIHW (Cout, Cin, 3, 3)."""
    return w.view(3, 3, *w.shape[1:]).permute(2, 3, 0, 1)


def upsample_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's x2 bilinear upsampling
    (align_corners=False) of x (B, s, s, C) NHWC -> (B, 2s, 2s, C): its
    source indices and weights, and its float ops in its order (that of
    PyTorch's CUDA upsample_bilinear2d, op by op)."""
    s = x.shape[1]
    d = torch.arange(2 * s, device=x.device, dtype=torch.float32)
    real = (0.5 * (d + 0.5) - 0.5).clamp(min=0)
    i0 = real.long()
    i1 = torch.where(i0 < s - 1, i0 + 1, i0)
    l1 = real - i0
    l0 = 1 - l1

    def cols(r):          # rows r (B, 2s, s, C) blended along x
        return (l0[:, None] * r[:, :, i0]) + (l1[:, None] * r[:, :, i1])
    h0, h1 = l0[:, None, None], l1[:, None, None]
    return (h0 * cols(x[:, i0])) + (h1 * cols(x[:, i1]))


def decoder_input(codes) -> torch.Tensor:
    """DECA's [pose[:, 3:] (jaw) | exp | detail] from DECACodes."""
    return torch.cat([codes.pose[:, 3:], codes.exp, codes.detail], dim=1)
