"""Device ms of the kernels launched inside the program's fr.flame spans of DECA's detail cell (FLAME's blendshapes, correctives, chain, skinning, landmarks, normals and the orthographic camera, ahead of the detail branch), on any thread, per microbatch (fr.render span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.flame', 'device_ms', per='fr.render')
