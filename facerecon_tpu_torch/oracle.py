"""Pure-numpy CPU golden oracle (a copy of facerecon_tpu/oracle.py, SURVEY.md
§5.1).

Independent (numpy-only, no torch arithmetic) implementations of the
geometry, SH and rasterization math of SURVEY.md §9. The port's contract
path and evaluate driver are held against it; it is also the stand-in for
the reference's CPU outputs in the fidelity contract ("bitwise-close to
the reference CPU outputs", BASELINE.md). Unbatched, float32,
deliberately simple.
"""

from __future__ import annotations

import numpy as np

from facerecon_tpu_torch.config import FaceReconConfig
from facerecon_tpu_torch.ops.sh import SH_SCALES


# --- geometry (SURVEY.md §9.1-9.3) ---

def split_coeff(coeff: np.ndarray, cfg: FaceReconConfig):
    return np.split(coeff, cfg.coeff_split, axis=-1)


def shape_formation(alpha, beta, assets):
    flat = (assets.mean_shape + assets.id_basis @ alpha
            + assets.exp_basis @ beta)
    return flat.reshape(-1, 3).astype(np.float32)


def texture_formation(delta, assets):
    flat = assets.mean_tex + assets.tex_basis @ delta
    return (flat / 255.0).reshape(-1, 3).astype(np.float32)


def compute_rotation(angles):
    theta, phi, psi = angles
    cx, sx = np.cos(theta), np.sin(theta)
    cy, sy = np.cos(phi), np.sin(phi)
    cz, sz = np.cos(psi), np.sin(psi)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=np.float32)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float32)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float32)
    return (rz @ ry @ rx).astype(np.float32)


def rigid_transform(shape, rotation, trans):
    return (shape @ rotation.T + trans).astype(np.float32)


def perspective_projection(verts, cfg: FaceReconConfig):
    zp = cfg.camera_distance - verts[:, 2]
    u = cfg.focal * verts[:, 0] / zp + cfg.center
    v = cfg.center - cfg.focal * verts[:, 1] / zp
    return np.stack([u, v], axis=-1).astype(np.float32)


def to_ndc(verts, cfg: FaceReconConfig):
    zp = cfg.camera_distance - verts[:, 2]
    half = cfg.image_size / 2.0
    x = cfg.focal * verts[:, 0] / zp / half
    y = cfg.focal * verts[:, 1] / zp / half
    return np.stack([x, y, zp], axis=-1).astype(np.float32)


def compute_norm(verts, faces):
    v0, v1, v2 = (verts[faces[:, k]] for k in range(3))
    face_n = np.cross(v1 - v0, v2 - v0)
    vert_n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vert_n, faces[:, k], face_n)
    norm = np.linalg.norm(vert_n, axis=-1, keepdims=True)
    return (vert_n / np.maximum(norm, 1e-8)).astype(np.float32)


# --- SH-9 (SURVEY.md §9.4) ---

def sh_basis(normals):
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]
    feats = np.stack([
        np.ones_like(nx), ny, nz, nx,
        nx * ny, ny * nz, 3.0 * nz * nz - 1.0,
        nx * nz, nx * nx - ny * ny], axis=-1)
    return (feats * SH_SCALES).astype(np.float32)


def illuminate(texture, normals, gamma):
    g = gamma.reshape(3, 9).copy()
    g[:, 0] += 1.0
    light = sh_basis(normals) @ g.T  # (N,3)
    return (texture * light).astype(np.float32)


# --- rasterizer (SURVEY.md §9.5 contract) ---

def ndc_to_screen(verts_ndc, height, width):
    """NDC -> pixel coords (u right, v down), same formula all backends use."""
    u = (verts_ndc[..., 0] + 1.0) * (width / 2.0)
    v = (1.0 - verts_ndc[..., 1]) * (height / 2.0)
    return np.stack([u, v], axis=-1).astype(np.float32)


def rasterize(verts_ndc, faces, height, width, chunk=512):
    """Brute-force z-buffer rasterization.

    Returns tri_id (H,W) int32 (-1 = background), bary (H,W,3) f32,
    zbuf (H,W) f32 (background = +inf). Pixel covered iff all three edge
    functions have the sign of the triangle's area (inclusive); nearest
    depth z' wins; ties -> smaller triangle id.

    Still brute force per chunk, but each chunk only evaluates the pixel
    ROWS its bounding box can touch: the edge-function arithmetic per
    evaluated pixel is bit-identical, and a pixel outside every corner's
    y-range is provably uncovered, so skipping it cannot change any
    winner. (The dense O(F x P) form took ~4 min per 224-image with
    21k faces — too slow for the on-chip parity suite, which runs 8.)
    """
    screen = ndc_to_screen(verts_ndc, height, width)  # (N,2)
    depth = verts_ndc[:, 2].astype(np.float32)

    jj, ii = np.meshgrid(np.arange(width), np.arange(height))
    pxg = (jj + 0.5).astype(np.float32)               # (H,W)
    pyg = (ii + 0.5).astype(np.float32)

    tri_id = np.full((height, width), -1, dtype=np.int32)
    zbuf = np.full((height, width), np.inf, dtype=np.float32)
    bary = np.zeros((height, width, 3), dtype=np.float32)

    n_faces = faces.shape[0]
    for start in range(0, n_faces, chunk):
        f = faces[start:start + chunk]
        p0, p1, p2 = screen[f[:, 0]], screen[f[:, 1]], screen[f[:, 2]]
        z0, z1, z2 = depth[f[:, 0]], depth[f[:, 1]], depth[f[:, 2]]
        # signed area*2 of each triangle (y-down coords)
        area = ((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
                - (p1[:, 1] - p0[:, 1]) * (p2[:, 0] - p0[:, 0]))
        live = np.abs(area) > 1e-12
        ys = np.concatenate([p0[live, 1], p1[live, 1], p2[live, 1]])
        if ys.size == 0:
            continue
        # pixel-center rows the chunk's bbox can cover (inclusive rule:
        # a center exactly on the bbox edge still needs evaluating)
        r0 = max(int(np.floor(ys.min() - 0.5)), 0)
        r1 = min(int(np.ceil(ys.max() - 0.5)) + 1, height)
        if r0 >= r1:
            continue
        px = pxg[r0:r1].reshape(-1)                   # (P',)
        py = pyg[r0:r1].reshape(-1)

        def edge(a, b):  # (C,P') edge function of segment a->b at pixels
            return ((b[:, 0] - a[:, 0])[:, None] * (py[None] - a[:, 1][:, None])
                    - (b[:, 1] - a[:, 1])[:, None]
                    * (px[None] - a[:, 0][:, None]))

        e0 = edge(p1, p2)  # opposite vertex 0
        e1 = edge(p2, p0)
        e2 = edge(p0, p1)
        s = np.sign(area)[:, None]
        covered = ((e0 * s >= 0) & (e1 * s >= 0) & (e2 * s >= 0)
                   & (np.abs(area)[:, None] > 1e-12))
        inv_area = np.where(area == 0, 0.0, 1.0 / area)[:, None]
        w0 = e0 * inv_area
        w1 = e1 * inv_area
        w2 = e2 * inv_area
        z = (w0 * z0[:, None] + w1 * z1[:, None]
             + w2 * z2[:, None]).astype(np.float32)
        z = np.where(covered, z, np.inf)

        # per-pixel winner within this chunk: smallest z, ties -> smaller id
        best = np.argmin(z, axis=0)  # argmin returns first min -> smaller id
        cols = np.arange(z.shape[1])
        bz = z[best, cols]
        zrows = zbuf[r0:r1].reshape(-1)
        update = bz < zrows  # strict: earlier chunk (smaller id) wins ties
        tid_rows = tri_id[r0:r1].reshape(-1)
        tri_id[r0:r1] = np.where(
            update, (start + best).astype(np.int32),
            tid_rows).reshape(r1 - r0, width)
        zbuf[r0:r1] = np.where(update, bz, zrows).reshape(r1 - r0, width)
        new_bary = np.stack(
            [w0[best, cols], w1[best, cols], w2[best, cols]], axis=-1)
        bary[r0:r1] = np.where(
            update[:, None], new_bary.astype(np.float32),
            bary[r0:r1].reshape(-1, 3)).reshape(r1 - r0, width, 3)

    return tri_id, bary, zbuf


# --- attribute interpolation + compositing (SURVEY.md §3 C9) ---

def interpolate(tri_id, bary, faces, attrs):
    """Gather per-vertex attrs by tri_id, blend by barycentric. (H,W,C)."""
    safe_id = np.maximum(tri_id, 0)
    tri_verts = faces[safe_id]             # (H,W,3)
    vals = attrs[tri_verts]                # (H,W,3,C)
    out = (bary[..., None] * vals).sum(axis=-2)
    return np.where((tri_id >= 0)[..., None], out, 0.0).astype(np.float32)


def render_coeffs(coeff, assets, cfg: FaceReconConfig, background=None,
                  rasterize_fn=None):
    """Full single-image render path: coeffs -> rendered image + extras.

    rasterize_fn: drop-in rasterizer override (e.g. the bitwise-identical
    native C++ one, utils/native_oracle.py, ~100x faster at full scale).
    """
    alpha, beta, delta, angles, gamma, trans = split_coeff(coeff, cfg)
    shape = shape_formation(alpha, beta, assets)
    tex = texture_formation(delta, assets)
    rot = compute_rotation(angles)
    verts = rigid_transform(shape, rot, trans)
    normals = compute_norm(shape, assets.faces) @ rot.T
    radiance = illuminate(tex, normals, gamma)
    vndc = to_ndc(verts, cfg)
    h = w = cfg.image_size
    tri_id, bary, zbuf = (rasterize_fn or rasterize)(
        vndc, assets.faces, h, w)
    color = interpolate(tri_id, bary, assets.faces, radiance)
    mask = (tri_id >= 0).astype(np.float32)
    if background is None:
        background = np.zeros((h, w, 3), dtype=np.float32)
    image = color * mask[..., None] + background * (1.0 - mask[..., None])
    lm = assets.landmark_index
    landmarks2d = perspective_projection(verts[lm], cfg)
    return dict(image=image.astype(np.float32), mask=mask, tri_id=tri_id,
                bary=bary, zbuf=zbuf, verts=verts, texture=tex,
                radiance=radiance, landmarks2d=landmarks2d, shape=shape)
