"""Device ms of the kernels launched inside the program's fr.geometry spans (coeffs_to_geometry and the SH lighting), on any thread, per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.geometry', 'device_ms', per='fr.render')
