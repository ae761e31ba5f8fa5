"""Device ms of the kernels launched inside the program's fr.records spans (the render records), on any thread, per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.records', 'device_ms', per='fr.render')
