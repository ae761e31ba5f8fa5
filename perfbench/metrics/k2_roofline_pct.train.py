"""K2 (csrc/raster_select.cu): the winner select's least time by its function's bytes and tests over its device time."""

from perfbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, 'select', ('raster_select_kernel',))
