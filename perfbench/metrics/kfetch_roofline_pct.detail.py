"""The detailed image's fetch (csrc/raster_texture.cu, raster_texfetch_kernel): its function's least time by the bytes and tests of work_detail.texfetch_work over the kernel's device time."""

from perfbench import work_detail


def read(ctx):
    return work_detail.texfetch_roofline_pct(ctx)
