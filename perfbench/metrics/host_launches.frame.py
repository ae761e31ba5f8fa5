"""Host calls that launch a kernel or a captured graph, per frame, in the traced stretch."""

from perfbench import readers


def read(ctx):
    return readers.launches_per_unit(ctx)
