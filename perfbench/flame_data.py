"""Seeded stand-ins for FLAME's and the albedo's published arrays, at the
published sizes (FLAME: Li et al., SIGGRAPH Asia 2017; DECA's use of it:
arXiv:2012.04012, decalib/models/FLAME.py and utils/renderer.py).

The model files are not in the repository, so `flame_arrays` draws every
array FLAME and DECA's coarse renderer read, from a seed, with the
published shapes and the published names:

  v_template (N, 3)           a head: an ellipsoid of `rings` latitude
                              rings x `cols` columns, the crown closed by
                              a zig-zag strip (no pole, so no vertex of
                              high degree) whose widest triangle is split
                              at its centroid, open at the neck, with a nose, a
                              narrower neck and a mouth slit of
                              `mouth_quads` quads (81 x 62 + 1 = 5,023
                              vertices, 2 x 62 x 80 + 60 + 2 - 6 = 9,976
                              faces at the defaults)
  faces (F, 3)                wound so the cross products point outward
  uvcoords (V_uv, 2)          a latitude-longitude map (v in [0.02, 0.8])
                              with its seam down the back of the head (a
                              ring's first column comes twice) and the
                              crown as an island of its own, a disc seen
                              from above (v > 0.8), so V_uv = rings x
                              (cols + 1) + cols + 1 > N (5,166; the
                              published head has 5,118)
  uvfaces (F, 3)              the faces over the UV vertices
  shapedirs (N, 3, S + E)     identity then expression: smooth random
                              fields, component k at 3 / sqrt(k) mm RMS a
                              unit of shape and 2 / sqrt(k) mm of
                              expression (the latter on the lower face),
                              so unit-normal codes move a vertex ~7 mm
                              and ~5 mm and fold no face
  posedirs (36, 3N)           the pose correctives: smooth fields, ~2 mm
                              RMS a unit of (R - I)
  J_regressor (5, N)          rows that sum to 1: Gaussian weights of the
                              template's vertices around the root, neck,
                              jaw and the two eyes
  lbs_weights (N, 5)          smooth rows that sum to 1 (root at the neck's
                              base, jaw on the chin, eyes around them, the
                              neck joint for the rest)
  parents (5,)                [-1, 0, 1, 1, 1]
  lmk_faces_idx (51,), lmk_bary_coords (51, 3)
                              static landmarks on random front faces at
                              random barycentrics
  dynamic_lmk_faces_idx (79, 17), dynamic_lmk_bary_coords (79, 17, 3)
                              the contour table, the same way
  albedo_mean (A * A * 3,)    the BFM-derived albedo's mean, laid out as
                              DECA reshapes it, (A, A, 3) with BGR
                              channels: smooth, in [0.3, 0.7]
  albedo_basis (A * A * 3, K) its first K principal components: white
                              noise of std 0.012, so a code of unit
                              normal components keeps the albedo mostly
                              within [0, 1]

Everything is float32 (int64 indices) and depends only on the sizes and
the seed."""

from __future__ import annotations

import numpy as np

PARENTS = (-1, 0, 1, 1, 1)
N_STATIC = 51
N_CONTOUR = 17
N_BINS = 79

# joint targets (m): root, neck, jaw, left eye, right eye
_JOINTS = np.array([[0.0, -0.085, -0.02], [0.0, -0.06, -0.02],
                    [0.0, -0.03, 0.01], [0.032, 0.02, 0.07],
                    [-0.032, 0.02, 0.07]], np.float64)


def head_mesh(rings: int, cols: int, mouth_quads: int):
    """(v_template (N, 3) float64, faces (F, 3), uvcoords (V_uv, 2),
    uvfaces (F, 3)): the head described in the module's docstring."""
    theta = np.linspace(np.radians(12.0), np.radians(150.0), rings)
    phi = np.pi + 2.0 * np.pi * np.arange(cols) / cols   # 0 at the back
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    x = 0.078 * st * np.sin(phi)[None]
    y = 0.11 * ct * np.ones_like(x)
    z = 0.095 * st * np.cos(phi)[None]
    narrow = 1.0 - 0.35 / (1.0 + np.exp((y + 0.06) / 0.012))    # the neck
    x, z = x * narrow, z * narrow
    z = z + 0.025 * np.exp(-(x / 0.015) ** 2 - ((y + 0.005) / 0.025) ** 2) \
        * (z > 0)                                              # the nose
    verts = np.stack([x, y, z], -1).reshape(-1, 3) + [0.0, -0.01, -0.02]
    v = 0.80 - 0.78 * np.arange(rings) / (rings - 1.0)
    u = np.arange(cols + 1) / cols
    uv = np.stack(np.broadcast_arrays(u[None], v[:, None]), -1).reshape(-1, 2)
    # the crown's own UV island: ring 0 seen from above, a disc of radius
    # 0.04 (the texel density of the rest) centred at (0.5, 0.9)
    crown_uv = np.stack([0.5 + 0.04 * np.sin(phi), 0.9 + 0.04 * np.cos(phi)],
                        -1)
    crown0 = len(uv)
    uv = np.concatenate([uv, crown_uv])

    def vid(r, c):
        return r * cols + c % cols

    def uid(r, c):
        return r * (cols + 1) + c

    # the crown: ring 0 closed by a zig-zag strip (no high-degree pole)
    cap, lo, hi = [], 0, cols - 1
    while hi - lo > 1:
        cap.append((lo, lo + 1, hi))
        lo += 1
        if hi - lo > 1:
            cap.append((lo, hi - 1, hi))
            hi -= 1
    # its middle (widest) triangle split at its centroid (the 5,023rd
    # vertex)
    t0 = cap.pop(len(cap) // 2)
    centre, ucentre = len(verts), len(uv)
    verts = np.concatenate([verts, verts[[vid(0, c) for c in t0]].mean(
        0, keepdims=True)])
    uv = np.concatenate([uv, uv[[crown0 + c for c in t0]].mean(
        0, keepdims=True)])
    faces = [tuple(vid(0, c) for c in t) for t in cap]
    uvf = [tuple(crown0 + c for c in t) for t in cap]
    for k in range(3):
        a, b = t0[k], t0[(k + 1) % 3]
        faces.append((vid(0, a), vid(0, b), centre))
        uvf.append((crown0 + a, crown0 + b, ucentre))
    # the mouth slit: the front's quads on the ring nearest y = -0.045
    mouth_r = int(np.argmin(np.abs(0.11 * np.cos(theta) - 0.01 + 0.045)))
    front = cols // 2
    mouth = {(mouth_r, front - mouth_quads // 2 + k)
             for k in range(mouth_quads)}
    for r in range(rings - 1):
        for c in range(cols):
            if (r, c) in mouth:
                continue
            a, b, d, e = vid(r, c), vid(r, c + 1), vid(r + 1, c), \
                vid(r + 1, c + 1)
            ua, ub, ud, ue = uid(r, c), uid(r, c + 1), uid(r + 1, c), \
                uid(r + 1, c + 1)
            faces += [(a, d, b), (b, d, e)]
            uvf += [(ua, ud, ub), (ub, ud, ue)]
    faces = np.asarray(faces, np.int64)
    uvf = np.asarray(uvf, np.int64)
    # outward winding: the cross product against the centroid's offset
    p = verts[faces]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    out = p.mean(1) - [0.0, -0.01, -0.02]
    flip = (n * out).sum(1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    uvf[flip] = uvf[flip][:, [0, 2, 1]]
    return verts, faces, uv, uvf


def _smooth_fields(rng, verts, n_fields: int, rms, centres: int = 48,
                   width: float = 0.04, weight=None):
    """(N, 3, n_fields): random combinations of Gaussian bumps over the
    template, field k scaled to rms[k] (m) RMS over the vertices."""
    q = verts[rng.choice(len(verts), centres, replace=False)]
    phi = np.exp(-((verts[:, None] - q[None]) ** 2).sum(-1)
                 / (2.0 * width ** 2))                          # (N, J)
    f = (phi @ rng.standard_normal((centres, 3 * n_fields))).reshape(
        len(verts), 3, n_fields)
    if weight is not None:
        f = f * weight[:, None, None]
    return f * (rms / np.sqrt((f ** 2).mean(axis=(0, 1)) + 1e-30))


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def flame_arrays(sizes: dict, mesh: dict, seed: int) -> dict:
    """The stand-in arrays (module docstring). sizes: n_shape, n_exp,
    n_tex, albedo_size; mesh: rings, cols, mouth_quads."""
    rng = np.random.default_rng(seed)
    verts, faces, uv, uvf = head_mesh(mesh["rings"], mesh["cols"],
                                      mesh["mouth_quads"])
    n = len(verts)
    x, y, z = verts.T
    lower = _sigmoid((-0.0 - y) / 0.02)

    def spectrum(k, first):
        return first / np.sqrt(np.arange(1, k + 1))
    shapedirs = np.concatenate([
        _smooth_fields(rng, verts, sizes["n_shape"],
                       spectrum(sizes["n_shape"], 3e-3)),
        _smooth_fields(rng, verts, sizes["n_exp"],
                       spectrum(sizes["n_exp"], 2e-3), weight=lower)], axis=2)
    posedirs = _smooth_fields(rng, verts, 36, np.full(36, 2e-3)).reshape(
        3 * n, 36).T
    d2 = ((verts[None] - _JOINTS[:, None]) ** 2).sum(-1)       # (5, N)
    jreg = np.exp(-d2 / (2.0 * 0.02 ** 2))
    jreg /= jreg.sum(1, keepdims=True)
    jaw = _sigmoid((-0.035 - y) / 0.008) * _sigmoid(z / 0.01)
    root = _sigmoid((-0.085 - y) / 0.008)
    eyes = 0.8 * np.exp(-d2[3:] / (2.0 * 0.012 ** 2))
    w = np.stack([root, np.zeros(n), jaw, eyes[0], eyes[1]], 1)
    w[:, 1] = np.maximum(1.0 - w.sum(1), 0.05)
    w /= w.sum(1, keepdims=True)
    # landmarks on faces that face the camera (front, |x| not at the rim)
    cen = verts[faces].mean(1)
    front = np.nonzero((cen[:, 2] > 0.02) & (cen[:, 1] > -0.075)
                       & (cen[:, 1] < 0.06))[0]
    side = np.nonzero((cen[:, 1] > -0.075) & (cen[:, 1] < 0.02))[0]

    def bary(*shape):
        b = rng.random((*shape, 3)) + 0.05
        return b / b.sum(-1, keepdims=True)
    a = sizes["albedo_size"]
    k = sizes["n_tex"]
    gy, gx = np.meshgrid(np.arange(a) / a, np.arange(a) / a, indexing="ij")
    base = 0.5 + 0.1 * np.sin(2 * np.pi * 3 * gx) * np.cos(2 * np.pi * 2 * gy)
    mean = base[..., None] + np.array([-0.05, 0.0, 0.06])     # BGR
    mean = mean + 0.03 * rng.standard_normal(mean.shape)
    out = {
        "v_template": verts, "faces": faces, "uvcoords": uv, "uvfaces": uvf,
        "shapedirs": shapedirs, "posedirs": posedirs, "J_regressor": jreg,
        "lbs_weights": w, "parents": np.asarray(PARENTS, np.int64),
        "lmk_faces_idx": rng.choice(front, N_STATIC),
        "lmk_bary_coords": bary(N_STATIC),
        "dynamic_lmk_faces_idx": rng.choice(side, (N_BINS, N_CONTOUR)),
        "dynamic_lmk_bary_coords": bary(N_BINS, N_CONTOUR),
        "albedo_mean": np.clip(mean, 0.3, 0.7).reshape(-1),
    }
    out = {key: (v.astype(np.int64) if v.dtype.kind in "iu"
                 else v.astype(np.float32)) for key, v in out.items()}
    out["albedo_basis"] = rng.standard_normal((a * a * 3, k),
                                              dtype=np.float32) * 0.012
    return out
