"""Inference-fused CNN regressor (twin of facerecon_tpu/models/fused.py).

The BN-folded, space-to-depth-stem ResNet: every conv+BatchNorm of the
training model is one biased conv, and the 7x7/stride-2 stem on 3
channels becomes an exact 4x4/stride-1 conv on 2x2 space-to-depth blocks
(12 channels). Convs compute in the model dtype (bf16 by default) in
channels_last layout; the pooled features and the head are float32.

The public input is NHWC (B, H, W, 3) float32, as in the reference.
Flax's SAME padding is asymmetric at stride 2 (more padding after than
before), so every conv and the max-pool pad explicitly; torch's
symmetric `padding=` would shift the sampling grid.

`fold_bn_model` folds the port's own BatchNorm model (models/resnet.py,
e.g. restored from a checkpoint the port trained) into this module's
state_dict. `fuse_variables` folds the reference's variables (nested
dicts of numpy arrays, flax layout) into the fused model's flax-layout
params; `jax_params.fused_state_dict` maps those onto this module. Both
folds run the same numpy float32 arithmetic.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facerecon_tpu_torch.config import FaceReconConfig, is_flame

STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
# random head weights give coefficients of ~0.15 std on random images:
# sample_coeffs's range, with the face in frame
_HEAD_STD = 0.3


def _same_pads(n: int, k: int, s: int):
    """Flax/XLA SAME padding (before, after) for one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(conv: nn.Conv2d, x):
    k, s = conv.kernel_size[0], conv.stride[0]
    (t, b), (l, r) = (_same_pads(x.shape[2], k, s),
                      _same_pads(x.shape[3], k, s))
    if t == b == l == r:
        return F.conv2d(x, conv.weight, conv.bias, s, t)
    return conv(F.pad(x, (l, r, t, b)))


class FusedBottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int, dtype):
        super().__init__()
        kw = dict(bias=True, dtype=dtype)
        self.conv0 = nn.Conv2d(in_ch, features, 1, **kw)
        self.conv1 = nn.Conv2d(features, features, 3, stride=strides, **kw)
        self.conv2 = nn.Conv2d(features, features * 4, 1, **kw)
        # residual projection where the shapes differ (flax Conv_3)
        self.proj = (nn.Conv2d(in_ch, features * 4, 1, stride=strides, **kw)
                     if in_ch != features * 4 or strides != 1 else None)

    def forward(self, x):
        y = F.relu(self.conv0(x))
        y = F.relu(_conv_same(self.conv1, y))
        y = self.conv2(y)
        residual = x if self.proj is None else _conv_same(self.proj, x)
        return F.relu(y + residual)


class FusedResNetRegressor(nn.Module):
    """BN-folded, s2d-stem ResNet -> global pool -> dense coeff head."""

    def __init__(self, n_coeff: int,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, dtype=torch.bfloat16, hidden: int = 0):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.Conv2d(12, width, 4, bias=True, dtype=dtype)
        blocks, in_ch = [], width
        for i, n_blocks in enumerate(stage_sizes):
            for k in range(n_blocks):
                strides = 2 if (i > 0 and k == 0) else 1
                blocks.append(FusedBottleneck(in_ch, width * 2 ** i,
                                              strides, dtype))
                in_ch = width * 2 ** i * 4
        self.blocks = nn.ModuleList(blocks)
        # DECA's two-layer head (hidden > 0): Linear, ReLU, Linear, float32
        self.head_hidden = (nn.Linear(in_ch, hidden, dtype=torch.float32)
                            if hidden else None)
        self.head = nn.Linear(hidden or in_ch, n_coeff, dtype=torch.float32)

    def forward(self, images):
        """images (B,H,W,3) float32 in [0,1] -> coeffs (B,n_coeff) f32."""
        x = images.to(self.dtype)
        b, h, w, c = x.shape
        # 2x2 space-to-depth, channel order (dy, dx, c) as in the reference
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.stem(F.pad(x, (1, 2, 1, 2))))
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
        """Random weights from `generator` (a CPU generator): LeCun-normal
        convs and hidden layer with zero biases, and a head scaled down by
        _HEAD_STD."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                std = (_HEAD_STD if mod is self.head else 1.0) / fan_in ** 0.5
                w = torch.randn(mod.weight.shape, generator=generator) * std
                mod.weight.copy_(w)
                mod.bias.zero_()
        return self


def build_fused_model(cfg: FaceReconConfig, depth: int = 50,
                      dtype=torch.bfloat16,
                      n_out: int = 0) -> FusedResNetRegressor:
    """As models/resnet.build_model, fused."""
    n = n_out or (cfg.n_coarse if is_flame(cfg) else cfg.n_coeff)
    return FusedResNetRegressor(n_coeff=n, stage_sizes=STAGES[depth],
                                dtype=dtype,
                                hidden=cfg.head_hidden if is_flame(cfg) else 0)


# --- numpy fold of the BN model's variables (flax layout) ---

def _bn_affine(bn_params, bn_stats, eps=1e-5):
    s = bn_params["scale"] / np.sqrt(np.asarray(bn_stats["var"]) + eps)
    t = bn_params["bias"] - s * bn_stats["mean"]
    return np.asarray(s, np.float32), np.asarray(t, np.float32)


def _fold(conv_kernel, bn_params, bn_stats):
    """conv (no bias) followed by BN  ->  (scaled kernel, bias)."""
    s, t = _bn_affine(bn_params, bn_stats)
    return np.asarray(conv_kernel, np.float32) * s[None, None, None, :], t


def _stem_to_s2d(w7: np.ndarray) -> np.ndarray:
    """(7,7,3,64) stride-2 HWIO kernel -> exact (4,4,12,64) s2d(2) kernel.

    With SAME padding for k=7/s=2 (before 2, after 3) the input pixel
    2i+u-2 of output i is block a, offset dy with 2a+dy = 2i+u-2, giving
    the tap W4[a-i+1, b-j+1, (dy, dx, c)] = W7[u, v, c] under s2d padding
    (1, 2)."""
    cin = w7.shape[2]
    w4 = np.zeros((4, 4, 4 * cin, w7.shape[3]), np.float32)
    for u in range(7):
        for v in range(7):
            a, dy = divmod(u - 2, 2)
            b, dx = divmod(v - 2, 2)
            w4[a + 1, b + 1, (dy * 2 + dx) * cin:(dy * 2 + dx + 1) * cin] \
                = w7[u, v]
    return w4


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def fuse_variables(variables, depth: int = 50):
    """Fold trained BN-model variables {'params', 'batch_stats'} (flax
    naming: Conv_i / BatchNorm_i in definition order, top level and in
    each BottleneckBlock_k) into the fused model's flax-layout params
    {'params': {'stem', 'FusedBottleneck_k', 'head'}}, all numpy."""
    params = _to_numpy(variables["params"])
    stats = _to_numpy(variables["batch_stats"])
    out = {}
    k7, bias0 = _fold(params["Conv_0"]["kernel"], params["BatchNorm_0"],
                      stats["BatchNorm_0"])
    out["stem"] = {"kernel": _stem_to_s2d(k7), "bias": bias0}
    for blk in range(sum(STAGES[depth])):
        bp = params[f"BottleneckBlock_{blk}"]
        bs = stats[f"BottleneckBlock_{blk}"]
        fb = {}
        n_convs = sum(1 for k in bp if k.startswith("Conv_"))
        for ci in range(n_convs):
            k, t = _fold(bp[f"Conv_{ci}"]["kernel"], bp[f"BatchNorm_{ci}"],
                         bs[f"BatchNorm_{ci}"])
            fb[f"Conv_{ci}"] = {"kernel": k, "bias": t}
        out[f"FusedBottleneck_{blk}"] = fb
    out["head"] = {"kernel": params["Dense_0"]["kernel"],
                   "bias": params["Dense_0"]["bias"]}
    return {"params": out}


def _fold_conv(conv: nn.Conv2d, bn) -> tuple:
    """A port conv (no bias, OIHW) and the BatchNorm after it -> (scaled
    OIHW kernel, bias), numpy float32, from the running statistics the
    eval-mode BatchNorm normalises with (and its eps, 1e-5)."""
    def np32(t):
        return t.detach().cpu().to(torch.float32).numpy()
    s, t = _bn_affine({"scale": np32(bn.weight), "bias": np32(bn.bias)},
                      {"mean": np32(bn.running_mean),
                       "var": np32(bn.running_var)})
    return np32(conv.weight) * s[:, None, None, None], t


@torch.no_grad()
def fold_bn_model(model) -> "OrderedDict[str, torch.Tensor]":
    """The port's BatchNorm ResNetRegressor -> a FusedResNetRegressor
    state_dict (float32): each conv folded with the BatchNorm that
    follows it, and the 7x7/stride-2 stem turned into the exact 4x4
    space-to-depth kernel (_stem_to_s2d). The fused model computes the
    BN model's eval-mode forward to float32 rounding."""
    out = OrderedDict()

    def put(name, w, b):
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[f"{name}.bias"] = torch.from_numpy(np.ascontiguousarray(b))

    w7, b0 = _fold_conv(model.stem, model.stem_bn)
    put("stem", _stem_to_s2d(w7.transpose(2, 3, 1, 0)).transpose(3, 2, 0, 1),
        b0)
    for i, blk in enumerate(model.blocks):
        pairs = [("conv0", blk.conv0, blk.bn0), ("conv1", blk.conv1, blk.bn1),
                 ("conv2", blk.conv2, blk.bn2)]
        if blk.proj is not None:
            pairs.append(("proj", blk.proj, blk.proj_bn))
        for name, conv, bn in pairs:
            put(f"blocks.{i}.{name}", *_fold_conv(conv, bn))
    heads = ([("head_hidden", model.head_hidden)]
             if model.head_hidden is not None else [])
    for name, lin in heads + [("head", model.head)]:
        put(name, lin.weight.detach().cpu().to(torch.float32).numpy(),
            lin.bias.detach().cpu().to(torch.float32).numpy())
    return out
