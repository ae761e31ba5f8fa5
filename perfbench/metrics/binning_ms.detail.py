"""Device ms of the kernels launched inside the program's fr.binning spans of DECA's detail cell (rasterize.band_windows ahead of the detailed image's fetch), on any thread, per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.binning', 'device_ms', per='fr.render')
