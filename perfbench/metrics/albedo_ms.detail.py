"""Device ms of the kernels launched inside the program's fr.albedo spans of DECA's detail cell (the UV albedo decode the detail texture multiplies), per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.albedo', 'device_ms', per='fr.render')
