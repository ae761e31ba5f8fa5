"""Device ms of the kernels launched inside the program's fr.records spans of DECA's detail cell (DECA's textured records with the rows' UVs, which the detailed image's fetch reads), on any thread, per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.records', 'device_ms', per='fr.render')
