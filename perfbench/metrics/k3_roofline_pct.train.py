"""K3 (csrc/select_grad.cu, its four kernels): the select adjoint's least time by its function's bytes over their device time."""

from perfbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, 'grad', readers.K3_SYMBOLS)
