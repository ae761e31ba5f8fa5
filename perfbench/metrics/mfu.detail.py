"""Whole-step share of the H100's peaks in DECA's detail cell: FLAME and the albedo decode at the float32 peak, the detail decoder's convolutions and linear layer at the TF32 tensor-core peak (work_detail.mfu), over the window's seconds a face."""

from perfbench import work_detail


def read(ctx):
    return work_detail.mfu(ctx)
