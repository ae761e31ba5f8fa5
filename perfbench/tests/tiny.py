"""Tiny cells for the CPU tests: each real cell's files with the sizes
cut to a 64-px image and a 500-vertex mesh, so the program's plain
(CPU) paths run in seconds."""

from __future__ import annotations

import copy

from perfbench import spec

TINY_SIZES = {"n_vertices": 500, "n_faces": 900}
TINY_BATCH = {"train224.b128": 8}


def cell(name: str, root=spec.ROOT, **traffic) -> dict:
    c = copy.deepcopy(spec.cell(name, root))
    f = c["config_file"]
    f["sizes"].update(TINY_SIZES)
    f["camera"].update(image_size=64, focal=1015.0 * 64 / 224)
    f["raster"].update(tile_h=2, raster_cols=2)
    t = c["traffic"]
    for k, v in (("batch", TINY_BATCH.get(name, 2)), ("microbatch", 2),
                 ("pool", 3),
                 ("calibration_batch", 4), ("frames", 3), ("sample", 2),
                 ("warmup_requests", 1), ("trace_units", 1)):
        if k in t:
            t[k] = v
    t.update(traffic)
    return c
