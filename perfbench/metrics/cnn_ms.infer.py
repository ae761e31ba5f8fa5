"""Device ms of the kernels launched inside the CNN's span (the regressor's forward, opened and closed by hooks on the program's model), per microbatch."""

from perfbench import readers


def read(ctx):
    return readers.span_ms(ctx, 'cnn')
