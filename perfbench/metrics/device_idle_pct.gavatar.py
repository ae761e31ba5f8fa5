"""Share of the window in which no kernel, copy or fill ran on the device: 100 - the busy union a unit in the traced stretch over the untraced window's seconds a unit."""

from perfbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
