"""Carry model weights from the reference's flax layout to the port.

`train_state_dict` maps the BatchNorm training model's variables
{'params', 'batch_stats'} (ResNetRegressor) onto the port's
models/resnet.py module:
  Conv_0 / BatchNorm_0              -> stem / stem_bn
  BottleneckBlock_i/Conv_0..2       -> blocks.i.conv0..conv2
  BottleneckBlock_i/BatchNorm_0..2  -> blocks.i.bn0..bn2
  BottleneckBlock_i/Conv_3, BatchNorm_3 -> blocks.i.proj, blocks.i.proj_bn
  Dense_0                           -> head
with BN scale/bias -> weight/bias and mean/var -> running_mean/var.

`fused_state_dict` takes the params of the reference's
FusedResNetRegressor as a tree of numpy arrays (the output of either
package's `fuse_variables`, or a checkpoint's params converted to numpy)
and returns the port's `state_dict`:
  stem                        -> stem
  FusedBottleneck_i/Conv_0..2 -> blocks.i.conv0..conv2
  FusedBottleneck_i/Conv_3    -> blocks.i.proj (the residual projection)
  head                        -> head
Conv kernels go from HWIO to OIHW; the Dense kernel (in, out) becomes the
Linear weight (out, in).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

_CONV_NAMES = {"Conv_0": "conv0", "Conv_1": "conv1", "Conv_2": "conv2",
               "Conv_3": "proj"}


def _conv(prefix, p, out):
    k = np.asarray(p["kernel"], np.float32)
    out[f"{prefix}.weight"] = torch.from_numpy(
        np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    out[f"{prefix}.bias"] = torch.tensor(np.asarray(p["bias"], np.float32))


def fused_state_dict(params) -> "OrderedDict[str, torch.Tensor]":
    if "params" in params:
        params = params["params"]
    out = OrderedDict()
    _conv("stem", params["stem"], out)
    n_blocks = sum(1 for k in params if k.startswith("FusedBottleneck_"))
    for i in range(n_blocks):
        blk = params[f"FusedBottleneck_{i}"]
        for name in sorted(blk):
            _conv(f"blocks.{i}.{_CONV_NAMES[name]}", blk[name], out)
    head = params["head"]
    out["head.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.asarray(head["kernel"], np.float32).T))
    out["head.bias"] = torch.tensor(np.asarray(head["bias"], np.float32))
    return out


_BN_NAMES = {"BatchNorm_0": "bn0", "BatchNorm_1": "bn1", "BatchNorm_2": "bn2",
             "BatchNorm_3": "proj_bn"}


def _tensor(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bn(prefix, p, stats, out):
    out[f"{prefix}.weight"] = _tensor(p["scale"])
    out[f"{prefix}.bias"] = _tensor(p["bias"])
    out[f"{prefix}.running_mean"] = _tensor(stats["mean"])
    out[f"{prefix}.running_var"] = _tensor(stats["var"])


def train_state_dict(variables) -> "OrderedDict[str, torch.Tensor]":
    """The training model's flax variables (trees of numpy arrays) as the
    port's ResNetRegressor state_dict. Conv kernels go from HWIO to OIHW;
    the Dense kernel (in, out) becomes the Linear weight (out, in)."""
    params, stats = variables["params"], variables["batch_stats"]
    out = OrderedDict()
    out["stem.weight"] = _tensor(
        np.asarray(params["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))
    _bn("stem_bn", params["BatchNorm_0"], stats["BatchNorm_0"], out)
    n_blocks = sum(1 for k in params if k.startswith("BottleneckBlock_"))
    for i in range(n_blocks):
        bp = params[f"BottleneckBlock_{i}"]
        bs = stats[f"BottleneckBlock_{i}"]
        for name in sorted(k for k in bp if k.startswith("Conv_")):
            out[f"blocks.{i}.{_CONV_NAMES[name]}.weight"] = _tensor(
                np.asarray(bp[name]["kernel"]).transpose(3, 2, 0, 1))
        for name in sorted(k for k in bp if k.startswith("BatchNorm_")):
            _bn(f"blocks.{i}.{_BN_NAMES[name]}", bp[name], bs[name], out)
    out["head.weight"] = _tensor(np.asarray(params["Dense_0"]["kernel"]).T)
    out["head.bias"] = _tensor(params["Dense_0"]["bias"])
    return out
