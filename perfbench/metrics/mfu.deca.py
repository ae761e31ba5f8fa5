"""Whole-step share of the H100's float32 peak in DECA's render cell: FLAME's blendshapes, pose correctives and skinning and the decode of the 256^2 x 3 albedo texels a face (work_flame.flops_per_face) over the window's seconds a face."""

from perfbench import work_flame


def read(ctx):
    return work_flame.mfu(ctx)
