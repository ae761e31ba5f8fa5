"""Device ms of the kernels, copies and fills launched inside the program's fr.splat_sort spans (the pair counts' prefix sum and its host read, the pairs' emit, the stable sort and the tile ranges), per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.splat_sort', 'device_ms', per='fr.render')
