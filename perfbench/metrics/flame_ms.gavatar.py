"""Device ms of the kernels launched inside the program's fr.flame spans (FLAME's blendshapes, correctives, chain and skinning under the full pose, and the translation), on any thread, per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.flame', 'device_ms', per='fr.render')
