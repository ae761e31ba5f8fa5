"""The blend (csrc/gaussians.cu gauss_blend_kernel): its function's least time by the bytes and ops of work_gavatar.splat_work (the pair tests each pixel needs up to its cut-off) over its device time."""

from perfbench import work_gavatar


def read(ctx):
    return work_gavatar.roofline_pct(ctx, 'gauss_blend_kernel', 1)
