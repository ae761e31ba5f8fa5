"""Whole-step share of the H100's peaks in a render cell (no CNN): the basis products' float32 FLOPs a face over the window's seconds a face."""

from perfbench import readers


def read(ctx):
    return readers.mfu(ctx, with_cnn=False, train=False)
