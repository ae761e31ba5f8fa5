"""The Gaussians' preprocess (csrc/gaussians.cu gauss_prep_kernel): its function's least time by the bytes and ops of work_gavatar.prep_work over its device time."""

from perfbench import work_gavatar


def read(ctx):
    return work_gavatar.roofline_pct(ctx, 'gauss_prep_kernel', 0)
