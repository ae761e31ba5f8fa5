"""Whole-step share of the H100's peaks at batch 1: the forward's FLOPs a frame over the window's seconds a frame."""

from perfbench import readers


def read(ctx):
    return readers.mfu(ctx, with_cnn=True, train=False)
