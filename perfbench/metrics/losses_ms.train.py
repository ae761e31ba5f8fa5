"""Device ms of the kernels launched inside the program's fr.losses span (total_loss), per training step (fr.backward span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.losses', 'device_ms', per='fr.backward')
