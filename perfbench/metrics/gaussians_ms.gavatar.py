"""Device ms of the kernels launched inside the program's fr.gaussians spans (the Gaussians' preprocess: frames, binding, covariance, projection, SH-3, radius and tiles), per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.gaussians', 'device_ms', per='fr.render')
