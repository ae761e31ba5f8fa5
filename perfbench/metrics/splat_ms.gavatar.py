"""Device ms of the kernels launched inside the program's fr.splat spans (the front-to-back blend of every tile's sorted Gaussians), per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.splat', 'device_ms', per='fr.render')
