"""The regressor's leaves, made on the device from the seed, and the
head's calibration.

Every leaf of reference/cnn.layout is drawn by a torch.Generator on the
run's device in a few large calls: the convolutions LeCun-normal
truncated at two standard deviations (as the reference initialises
them), each BatchNorm as the configuration's `init` states (scale 1, or
uniform in `bn_last_scale` for each block's last BatchNorm, whose zero
start would leave the residual branches out of the output and out of
the gradients; bias, running mean and running variance drawn, so that
folding them is real work), and the head normal with std 1/sqrt(2048).

`calibrate_head` then scales the head's rows group by group so that the
coefficients regressed from one calibration batch have the spread of
frozen.sample_coeffs in each group (id, exp, tex, angles, gamma, t), and
sets the bias so that their mean is that distribution's mean. Every
image is then a different posed, lit face."""

from __future__ import annotations

import torch

from perfbench import frozen
from perfbench.reference import cnn


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def make_leaves(n_coeff: int, seed: int, device, init: dict) -> dict:
    """name -> float32 leaf on `device`, from `seed`."""
    lay = cnn.layout(n_coeff)
    g = generator(seed, device, stream=1)
    out = {}
    convs = [(n, s) for n, s, k in lay if k == "conv"]
    total = sum(torch.Size(s).numel() for _, s in convs)
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    at = 0
    for name, shape in convs:
        n = torch.Size(shape).numel()
        fan_in = torch.Size(shape[1:]).numel()
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        out[name] = (flat[at:at + n] * std).reshape(shape)
        at += n
    vec = [(n, s, k) for n, s, k in lay if k.startswith("bn")]
    total = sum(s[0] for _, s, _ in vec)
    u = torch.rand(total, device=device, generator=g)
    z = torch.randn(total, device=device, generator=g)
    at = 0
    lo, hi = init["bn_last_scale"]
    vlo, vhi = init["bn_var"]
    for name, (c,), kind in vec:
        uu, zz = u[at:at + c], z[at:at + c]
        at += c
        out[name] = {"bn_w": torch.ones_like(uu),
                     "bn_w_last": lo + (hi - lo) * uu,
                     "bn_b": zz * init["bn_bias_std"],
                     "bn_mean": zz * init["bn_mean_std"],
                     "bn_var": vlo + (vhi - vlo) * uu}[kind].contiguous()
    (hw, hs, _), (hb, bs, _) = lay[-2], lay[-1]
    out[hw] = torch.randn(hs, device=device, generator=g) / hs[1] ** 0.5
    out[hb] = torch.zeros(bs, device=device)
    return out


@torch.no_grad()
def calibrate_head(leaves: dict, feats: torch.Tensor, sizes: dict) -> None:
    """Scales head.weight per coefficient group so the regressed
    coefficients of `feats` (B, 2048) have sample_coeffs's spread in each
    group, and sets head.bias so their mean is its mean."""
    w = leaves["head.weight"].double()
    f = feats.double()
    z = f @ w.T
    spread = frozen.coeff_spread(sizes)
    for name, sl in frozen.group_slices(sizes).items():
        var = z[:, sl].var(dim=0, unbiased=False).mean()
        w[sl] *= spread[name][1] / var.clamp(min=1e-30).sqrt()
    mean = f.mean(0)
    bias = torch.cat([torch.full((sl.stop - sl.start,), spread[g][0],
                                 dtype=torch.float64, device=w.device)
                      for g, sl in frozen.group_slices(sizes).items()])
    leaves["head.weight"] = w.float().contiguous()
    leaves["head.bias"] = (bias - w @ mean).float().contiguous()


def trainable(n_coeff: int) -> list:
    """The leaves an optimizer updates (all but the running statistics)."""
    return [n for n, _, k in cnn.layout(n_coeff)
            if k not in ("bn_mean", "bn_var")]
