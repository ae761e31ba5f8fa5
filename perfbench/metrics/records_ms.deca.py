"""Device ms of the kernels launched inside the program's fr.records spans (DECA's textured records: world-normal corners, affine forms, anchors and the rows' UVs), on any thread, per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.records', 'device_ms', per='fr.render')
