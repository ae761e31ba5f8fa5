"""Whole-step share of the H100's peaks in a training cell: three times the forward's bf16 CNN and float32 basis FLOPs a face over the window's seconds a face."""

from perfbench import readers


def read(ctx):
    return readers.mfu(ctx, with_cnn=True, train=True)
