"""ResNet-50 coefficient regressor (He et al., arXiv:1512.03385), plain
float32, functional over a dict of leaves.

Leaf names and layouts are the usual torch ones (OIHW convolutions,
BatchNorm weight/bias/running_mean/running_var, head (n_coeff, 2048)),
so the benchmark makes one set of leaves for both sides. Padding is
XLA's SAME (asymmetric at stride 2, the layout the configuration
states); BatchNorm has eps 1e-5 and normalises with the biased variance
of the batch in training mode and with the running statistics in eval
mode."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import quant

EPS = 1e-5


def layout(n_coeff: int, stages=(3, 4, 6, 3), width: int = 64):
    """[(name, shape, kind)] of every leaf, in the torch state-dict
    order. kind: conv (fan-in in shape[1:]), bn_w, bn_b, bn_mean, bn_var,
    bn_w_last (each block's last BatchNorm scale), head_w, head_b."""
    out = [("stem.weight", (width, 3, 7, 7), "conv")]

    def bn(prefix, ch, last=False):
        return [(f"{prefix}.weight", (ch,), "bn_w_last" if last else "bn_w"),
                (f"{prefix}.bias", (ch,), "bn_b"),
                (f"{prefix}.running_mean", (ch,), "bn_mean"),
                (f"{prefix}.running_var", (ch,), "bn_var")]

    out += bn("stem_bn", width)
    in_ch, k = width, 0
    for i, n_blocks in enumerate(stages):
        feat = width * 2 ** i
        for j in range(n_blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            p = f"blocks.{k}"
            out += [(f"{p}.conv0.weight", (feat, in_ch, 1, 1), "conv")]
            out += bn(f"{p}.bn0", feat)
            out += [(f"{p}.conv1.weight", (feat, feat, 3, 3), "conv")]
            out += bn(f"{p}.bn1", feat)
            out += [(f"{p}.conv2.weight", (feat * 4, feat, 1, 1), "conv")]
            out += bn(f"{p}.bn2", feat * 4, last=True)
            if in_ch != feat * 4 or stride != 1:
                out += [(f"{p}.proj.weight", (feat * 4, in_ch, 1, 1), "conv")]
                out += bn(f"{p}.proj_bn", feat * 4)
            in_ch, k = feat * 4, k + 1
    out += [("head.weight", (n_coeff, in_ch), "head_w"),
            ("head.bias", (n_coeff,), "head_b")]
    return out


def blocks(stages=(3, 4, 6, 3), width: int = 64):
    """[(prefix, stride, has_proj)] of the bottleneck blocks."""
    out, in_ch, k = [], width, 0
    for i, n_blocks in enumerate(stages):
        feat = width * 2 ** i
        for j in range(n_blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            out.append((f"blocks.{k}", stride,
                        in_ch != feat * 4 or stride != 1))
            in_ch, k = feat * 4, k + 1
    return out


def same_pads(n: int, k: int, s: int):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, stride: int, precision: str):
    k = w.shape[-1]
    (t, b), (l, r) = same_pads(x.shape[2], k, stride), same_pads(
        x.shape[3], k, stride)
    x = F.pad(x, (l, r, t, b))
    if precision == "fp8":
        return quant.grad_fp8(F.conv2d(quant.fp8(x), quant.fp8(w), None,
                                       stride))
    return F.conv2d(x, w, None, stride)


def batch_norm(x, p, prefix: str, train: bool):
    w, b = p[f"{prefix}.weight"], p[f"{prefix}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
    scale = w / torch.sqrt(var + EPS)
    return x * scale[:, None, None] + (b - mean * scale)[:, None, None]


def features(p, images, train: bool, precision: str = "f32",
             stages=(3, 4, 6, 3), width: int = 64):
    """images (B, H, W, 3) float32 -> pooled features (B, 2048)."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(batch_norm(conv(x, p["stem.weight"], 2, precision), p,
                          "stem_bn", train))
    (t, b), (l, r) = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), 3, 2)
    for prefix, stride, has_proj in blocks(stages, width):
        y = F.relu(batch_norm(conv(x, p[f"{prefix}.conv0.weight"], 1,
                                   precision), p, f"{prefix}.bn0", train))
        y = F.relu(batch_norm(conv(y, p[f"{prefix}.conv1.weight"], stride,
                                   precision), p, f"{prefix}.bn1", train))
        y = batch_norm(conv(y, p[f"{prefix}.conv2.weight"], 1, precision), p,
                       f"{prefix}.bn2", train)
        if has_proj:
            x = batch_norm(conv(x, p[f"{prefix}.proj.weight"], stride,
                                precision), p, f"{prefix}.proj_bn", train)
        x = F.relu(y + x)
    return x.mean(dim=(2, 3))


def head(p, feats, precision: str = "f32"):
    return quant.matmul(feats, p["head.weight"].T, precision) + p["head.bias"]


def regress(p, images, train: bool, precision: str = "f32"):
    """images (B, H, W, 3) -> coefficients (B, n_coeff)."""
    return head(p, features(p, images, train, precision), precision)
