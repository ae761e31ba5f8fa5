"""Pretrained-weights import converter (twin of
facerecon_tpu/convert_weights.py) — SURVEY.md §6 (checkpoint row).

The reference family ships TF-1.x checkpoints of the coefficient-
regressor CNN; torchvision ships ResNet state dicts. The port's BatchNorm
regressor (models/resnet.py) keeps torch's layouts (OIHW convs, (out, in)
Linear), so a torch state dict imports with no transpose. Two paths, as
in the reference:

  * `import_torch_resnet(model, flat)` maps a torchvision-style ResNet
    state dict by the structured `_resnet_key_map` (stage, block,
    parameter kind), never by name suffix, which mis-maps same-shaped
    layers;
  * `import_flat(model, flat)` maps any {name: array} dict (a TF
    checkpoint read by `from_tf_checkpoint`) by the reference's
    name-and-shape rule on each weight's flax address and flax layout
    (`flatten_params`, the inverse of jax_params.train_state_dict), so
    one checkpoint lands on the same weights in both packages.

Both return a new state dict and a report; `main` writes it as a port
checkpoint (step 0) that `infer --ckpt` and `track --ckpt` read.

Usage:
  python -m facerecon_tpu_torch.convert_weights --torch sd.pt --out ckpt_dir
  python -m facerecon_tpu_torch.convert_weights --tf model.ckpt --out ckpt_dir
"""

from __future__ import annotations

import argparse
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

from facerecon_tpu_torch.jax_params import _BN_NAMES, _CONV_NAMES

# the port's module names -> the flax ones (jax_params' map, inverted)
_FLAX_MODULE = {v: k for k, v in {**_CONV_NAMES, **_BN_NAMES}.items()}


def _flax_address(key: str) -> str:
    """A parameter of the port's ResNetRegressor -> its flax address in
    the reference's 'params' tree ('BottleneckBlock_3/BatchNorm_1/scale')."""
    *mod, leaf = key.split(".")
    top = {"stem": "Conv_0", "stem_bn": "BatchNorm_0", "head": "Dense_0"}
    module = (top[mod[0]] if len(mod) == 1 else
              f"BottleneckBlock_{mod[1]}/{_FLAX_MODULE[mod[2]]}")
    if leaf == "weight":
        leaf = "scale" if "BatchNorm" in module else "kernel"
    return f"{module}/{leaf}"


def _to_flax(a: np.ndarray) -> np.ndarray:
    """torch layout -> flax layout: OIHW -> HWIO, (out, in) -> (in, out);
    a vector stays as it is."""
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T


def _from_flax(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def _addresses(model) -> "OrderedDict[str, str]":
    """flax address -> the port's parameter name, in the order jax
    flattens the reference's params (sorted addresses)."""
    names = {_flax_address(k): k for k, _ in model.named_parameters()}
    return OrderedDict(sorted(names.items()))


def flatten_params(model) -> Dict[str, np.ndarray]:
    """The model's weights as the reference's flatten_params gives its
    params: {flax address: array in flax layout}."""
    params = dict(model.named_parameters())
    out = {}
    for addr, key in _addresses(model).items():
        out[addr] = _to_flax(params[key].detach().cpu().numpy())
    return out


def import_flat(model, flat: Mapping[str, np.ndarray],
                strict: bool = False):
    """Map a flat {name: array} dict onto the model's weights by
    name+shape, as the reference's import_flat maps it onto its flax
    params: names are matched on the normalized tail (case/sep-
    insensitive) of each weight's flax address, and arrays must match
    its flax-layout shape exactly. Unmatched weights keep their values;
    running statistics are left as they are.
    Returns (new state_dict, report dict)."""
    def norm(k: str) -> str:
        return k.lower().replace(".", "/").replace("-", "_")

    budget = {norm(k): np.asarray(v) for k, v in flat.items()}
    used, missed = [], []
    sd = OrderedDict((k, v.detach().clone())
                     for k, v in model.state_dict().items())
    addresses = _addresses(model)
    for addr, leaf in flatten_params(model).items():
        key = addresses[addr]
        nk = norm(addr)
        for cand, arr in budget.items():
            if (cand.endswith(nk) or nk.endswith(cand)) \
                    and arr.shape == leaf.shape:
                used.append(cand)
                sd[key] = torch.tensor(_from_flax(arr), dtype=sd[key].dtype)
                break
        else:
            missed.append(addr)
    report = {"matched": len(used), "unmatched": len(missed),
              "unmatched_keys": missed[:20]}
    if strict and missed:
        raise ValueError(f"unmatched parameters: {missed[:10]} ...")
    return sd, report


def _resnet_key_map(depth: int = 50) -> Dict[str, str]:
    """Deterministic torchvision-ResNet name -> the port's state_dict
    name, structured on (layer index, block index, param kind) as the
    reference's map is (its flax addresses become models/resnet.py's
    names: stem, stem_bn, blocks.i.conv0..2, bn0..2, proj, proj_bn,
    head)."""
    stages = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}[depth]

    def bn(prefix, module):
        return {f"{prefix}.{t}": f"{module}.{t}" for t in (
            "weight", "bias", "running_mean", "running_var")}

    m = {"conv1.weight": "stem.weight",
         "fc.weight": "head.weight", "fc.bias": "head.bias"}
    m.update(bn("bn1", "stem_bn"))
    blk = 0
    for li, n_blocks in enumerate(stages):
        for k in range(n_blocks):
            mod, pre = f"blocks.{blk}", f"layer{li + 1}.{k}"
            for j in (1, 2, 3):
                m[f"{pre}.conv{j}.weight"] = f"{mod}.conv{j - 1}.weight"
                m.update(bn(f"{pre}.bn{j}", f"{mod}.bn{j - 1}"))
            if k == 0:
                # only the first block of a stage projects the residual
                # (channel/stride change), in torchvision and in
                # models/resnet.py
                m[f"{pre}.downsample.0.weight"] = f"{mod}.proj.weight"
                m.update(bn(f"{pre}.downsample.1", f"{mod}.proj_bn"))
            blk += 1
    return m


def import_torch_resnet(model, flat: Mapping[str, np.ndarray],
                        depth: int = 50):
    """Import a torchvision-style ResNet state_dict (a flat numpy dict,
    from from_torch_state_dict) into the model's weights and running
    statistics by the structured _resnet_key_map. The classifier head is
    skipped when its shape differs (the regressor emits coefficients, not
    classes). torchvision's running_var is copied as it is, as the
    reference copies it.

    Returns (new state_dict, report) where report lists every decision."""
    key_map = _resnet_key_map(depth)
    sd = OrderedDict((k, v.detach().clone())
                     for k, v in model.state_dict().items())
    imported, skipped, unknown = [], [], []
    for name, arr in flat.items():
        if name not in key_map:
            unknown.append(name)
            continue
        key = key_map[name]
        arr = np.asarray(arr)
        if tuple(sd[key].shape) != arr.shape:
            skipped.append((name, tuple(arr.shape), tuple(sd[key].shape)))
            continue
        sd[key] = torch.tensor(arr, dtype=sd[key].dtype)
        imported.append(name)
    missing = [k for k in key_map
               if k not in flat and not k.startswith("fc.")]
    report = {"imported": len(imported), "shape_skipped": skipped,
              "unknown_keys": unknown,
              "missing_expected": missing}
    return sd, report


def from_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A saved torch state dict (or module) -> {name: numpy array}, in
    torch's own layouts."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def from_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    try:
        import tensorflow as tf
    except Exception as e:
        raise RuntimeError("tensorflow unavailable for TF ckpt import") from e
    reader = tf.train.load_checkpoint(path)
    return {k: reader.get_tensor(k)
            for k in reader.get_variable_to_shape_map()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--torch", default=None)
    p.add_argument("--tf", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)

    from facerecon_tpu_torch.checkpoint import CheckpointManager
    from facerecon_tpu_torch.config import default_config, tiny_config
    from facerecon_tpu_torch.models.resnet import build_model

    cfg = tiny_config() if args.tiny else default_config()
    model = build_model(cfg).reset_parameters_(
        torch.Generator().manual_seed(0))
    if args.torch:
        sd, report = import_torch_resnet(model,
                                         from_torch_state_dict(args.torch))
    elif args.tf:
        sd, report = import_flat(model, from_tf_checkpoint(args.tf))
    else:
        raise SystemExit("provide --torch or --tf")

    print(report)
    CheckpointManager(args.out).save(0, {"model": sd, "step": 0})
    print(f"saved converted checkpoint to {args.out}")


if __name__ == "__main__":
    main()
