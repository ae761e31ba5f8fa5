"""Rounding to the control's lower precisions, as plain float32 ops.

`tf32` rounds to TF32's 10 explicit mantissa bits (round to nearest
even), as the tensor cores read float32 operands; `fp8` scales a tensor
so its largest magnitude is e4m3's 448, casts to float8_e4m3fn and back.
Both pass gradients straight through; `grad_tf32` and `grad_fp8` leave
the forward alone and round the gradient that flows back (fp8's in
e5m2, as fp8 training keeps gradients), so a product computed from
rounded operands has its backward products rounded too."""

from __future__ import annotations

import torch

FP8_MAX = 448.0
E5M2_MAX = 57344.0


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    return x + (_tf32_round(x.detach()) - x).detach()


def fp8(x: torch.Tensor) -> torch.Tensor:
    d = x.detach()
    scale = d.abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (d / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - d).detach()


def _fp8_e5m2(g):
    scale = g.abs().amax().clamp(min=1e-30) / E5M2_MAX
    return (g / scale).to(torch.float8_e5m2).to(torch.float32) * scale


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, how):
        ctx.how = how
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (_fp8_e5m2(g) if ctx.how == "fp8" else _tf32_round(g)), None


def grad_tf32(x):
    return _RoundGrad.apply(x, "tf32")


def grad_fp8(x):
    return _RoundGrad.apply(x, "fp8")


def matmul(a, b, precision: str = "f32"):
    if precision in ("tf32", "fp8"):
        return grad_tf32(tf32(a) @ tf32(b))
    return a @ b
