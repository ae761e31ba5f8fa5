"""Device ms of the kernels launched inside the program's fr.uv_detail spans (world2uv, the displaced dense grid's normals, the blend and the SH-shaded UV texture), per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.uv_detail', 'device_ms', per='fr.render')
