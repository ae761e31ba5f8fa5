"""Device ms of the kernels launched inside the program's fr.render span (geometry through K2, the shading from the select, the composite), per training step (fr.backward span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.render', 'device_ms', per='fr.backward')
