"""Device ms of the kernels launched inside the CNN's forward span, per training step."""

from perfbench import readers


def read(ctx):
    return readers.span_ms(ctx, 'cnn')
