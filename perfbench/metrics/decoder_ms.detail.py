"""Device ms of the kernels launched inside the program's fr.decoder spans (DECA's detail decoder: the linear layer, five upsamplings and convolutions, the last convolution and tanh), per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.decoder', 'device_ms', per='fr.render')
