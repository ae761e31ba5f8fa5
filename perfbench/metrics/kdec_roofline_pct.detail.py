"""The detail decoder's kernels (csrc/upconv.cu: upconv_kernel, five a microbatch, and outconv_kernel, one): the decoder's least time after its linear layer by perfbench/work_decoder (per layer the larger of FLOPs at the TF32 peak and bytes) over their device time."""

from perfbench import work_decoder


def read(ctx):
    return work_decoder.roofline_pct(ctx)
