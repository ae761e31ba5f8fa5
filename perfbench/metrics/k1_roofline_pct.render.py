"""K1 (csrc/raster_shade.cu): the shaded raster's least time by its function's bytes and tests over its device time."""

from perfbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, 'shade', ('raster_shade_kernel',))
