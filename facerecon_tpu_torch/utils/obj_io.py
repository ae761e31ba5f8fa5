"""OBJ mesh export/import (a copy of facerecon_tpu/utils/obj_io.py) —
SURVEY.md §3 C20, format per §9.8.

`v x y z r g b` per vertex (per-vertex color), `f i j k` 1-indexed faces,
CCW as stored.
"""

from __future__ import annotations

import numpy as np


def save_obj(path: str, vertices, colors=None, faces=None) -> None:
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    lines = []
    if colors is not None:
        colors = np.asarray(colors, dtype=np.float32).reshape(-1, 3)
        for v, c in zip(vertices, colors):
            lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                         f"{c[0]:.6f} {c[1]:.6f} {c[2]:.6f}")
    else:
        for v in vertices:
            lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    if faces is not None:
        faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
        for f in faces:
            lines.append(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def load_obj(path: str):
    """Round-trip reader for tests: returns (vertices, colors|None, faces)."""
    verts, cols, faces = [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vals = [float(x) for x in parts[1:]]
                verts.append(vals[:3])
                if len(vals) >= 6:
                    cols.append(vals[3:6])
            elif parts[0] == "f":
                faces.append([int(x.split("/")[0]) - 1 for x in parts[1:4]])
    v = np.array(verts, dtype=np.float32)
    c = np.array(cols, dtype=np.float32) if cols else None
    f = np.array(faces, dtype=np.int32) if faces else None
    return v, c, f
