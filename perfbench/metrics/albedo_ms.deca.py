"""Device ms of the kernels launched inside the program's fr.albedo spans (the UV albedo decode), per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.albedo', 'device_ms', per='fr.render')
