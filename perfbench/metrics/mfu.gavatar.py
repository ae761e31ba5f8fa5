"""Whole-step share of the H100's float32 peak in the avatar's cell: FLAME's FLOPs and the preprocess's and the blend's ops a frame (work_gavatar, the blend's from the reference's render of the traced codes) over the window's seconds a frame."""

from perfbench import work_gavatar


def read(ctx):
    return work_gavatar.mfu(ctx)
