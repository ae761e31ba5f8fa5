"""The least time DECA's detail decoder needs after its linear layer,
counted from the configuration's widths whatever implements it, for
`kdec_roofline_pct` (the decoder's kernels' share of it).

Per upsampling layer (x2 bilinear, 3x3 convolution, bias, LeakyReLU) the
larger of its FLOPs (2 a multiply-add of the convolution at its output
size) at the dense TF32 peak (work_detail.PEAK_TF32) and its bytes at
work.PEAK_BYTES: the float32 input read once, the output written once,
the weights and bias once. The last convolution, tanh and scale count by
bytes alone (16 channels in, one out, float32). At 256 faces and DECA's
widths the sum is ~1.41 ms. The device time divided into it is that of
the functions named in SYMBOLS: a program without them reads nothing.
"""

from __future__ import annotations

from perfbench import work, work_detail

SYMBOLS = ("upconv_kernel", "outconv_kernel")


def layers(cfgf: dict, batch: int):
    """[(FLOPs, bytes)] of each upsampling layer, then of the last
    convolution (FLOPs 0: it counts by bytes)."""
    dec = cfgf["decoder"]
    ch = dec["channels"]
    s = dec["start_size"]
    out = []
    for cin, cout in zip(ch[:-1], ch[1:]):
        macs = batch * (2 * s) ** 2 * cout * cin * 9
        nbytes = 4 * (batch * s * s * cin + batch * (2 * s) ** 2 * cout
                      + 9 * cin * cout + cout)
        out.append((2 * macs, nbytes))
        s *= 2
    co = dec["out_channels"]
    out.append((0, 4 * (batch * s * s * (ch[-1] + co) + 9 * ch[-1] * co
                        + co)))
    return out


def least_seconds(cfgf: dict, batch: int) -> float:
    return sum(max(f / work_detail.PEAK_TF32, b / work.PEAK_BYTES)
               for f, b in layers(cfgf, batch))


def roofline_pct(ctx):
    """100 x the mean least time of the traced microbatches x the
    microbatches (the last convolution's launches, one each) over the
    device time of the decoder's kernels."""
    tr = ctx.get("trace")
    kind = ctx["kind"]
    if tr is None or not kind.captured:
        return None
    counts = [tr.kernel_seconds(s) for s in SYMBOLS]
    launches = counts[-1][0]
    secs = sum(t for _, t in counts)
    if launches == 0 or secs <= 0:
        return None
    bounds = [least_seconds(kind.cfgf, codes.shape[0])
              for codes in kind.captured]
    return 100.0 * sum(bounds) / len(bounds) * launches / secs
