"""The textured shade (csrc/raster_texture.cu): its function's least time by the bytes and tests of work_flame.texture_work over raster_texture_kernel's device time."""

from perfbench import work_flame


def read(ctx):
    return work_flame.roofline_pct(ctx, 'raster_texture_kernel')
