"""Whole-step share of the H100's peaks in an inference cell: ResNet-50 in bf16 and the basis products in float32, per face, over the window's seconds a face."""

from perfbench import readers


def read(ctx):
    return readers.mfu(ctx, with_cnn=True, train=False)
