"""Carry fused-model weights from the reference's flax layout to the port.

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
