"""FLAME asset layer for DECA's coarse model (arXiv:2012.04012).

The arrays DECA's `decalib/models/FLAME.py` and `utils/renderer.py` read,
under their published names, packed once into an `.npz` and uploaded to
the device a single time (`ops/flame.device_flame`):

  v_template (N, 3)             shapedirs (N, 3, n_shape + n_exp)
  posedirs (36, 3N)             J_regressor (5, N)
  lbs_weights (N, 5)            parents (5,): [-1, 0, 1, 1, 1]
  faces (F, 3)                  uvcoords (V_uv, 2) in [0, 1]
  uvfaces (F, 3)                lmk_faces_idx (51,), lmk_bary_coords (51, 3)
  dynamic_lmk_faces_idx (79, 17), dynamic_lmk_bary_coords (79, 17, 3)
  albedo_mean (A * A * 3,)      albedo_basis (A * A * 3, K): the
                                BFM-derived albedo, (A, A, 3) BGR rows as
                                DECA reshapes them, K >= n_tex components

and the tables the port derives from them: the vertex-face adjacency of
the normals (utils/bfm.vertex_face_adjacency) and the static raster row
order (utils/bfm.raster_row_order, from the template under an
orthographic scale of RASTER_CAM_SCALE).

DECA's detail model adds two arrays (RAW_DETAIL), read where both are
given: fixed_uv_dis (S, S), a fixed displacement added along the coarse
normal, and uv_face_eye_mask (S, S), the texels whose displacement and
normals the detail model sets (the face less the eyes). From them and
the UV layout the pack derives (`DetailAssets`):
  - the UV texel table (`uv_texel_table`): for each of the S x S texels,
    the UV face that covers its centre and the barycentrics there, which
    is DECA's world2uv (a rasterization of the UV layout, uvcoords x 2 -
    1 with v negated, by uvfaces) done once, since the layout is the same
    for every face. The centre of texel (row j, column i) is the grid
    point ((2i + 1) / S - 1, (2j + 1) / S - 1), the point
    F.grid_sample(align_corners=False) reads texel (j, i) at, so world2uv
    and the image's fetch use one convention. DECA rasterizes with
    PyTorch3D after negating x and y, whose +X-left, +Y-up NDC puts the
    pixel centres at the same points (the two flips cancel); a centre on
    an edge counts as covered here (PyTorch3D's test is strict), and a
    centre two faces cover takes the lower face id (DECA's UV depth is a
    constant 1, which leaves the tie to PyTorch3D's order). Texels no face
    covers have face -1 and read 0, as DECA's;
  - nothing for the dense grid (DECA's util.generate_triangles with
    margins DENSE_MARGINS, 2 and 5: the S^2 texels as a mesh of
    2 (S - 5)(S - 11) faces, 122,990 at S = 256, whose vertex normals are
    the detail normals): it is regular, so ops/detail reads it as a
    stencil.
A loader for the published
files (FLAME's pickle, the albedo's npz, the landmark embedding and the
head template's UVs) is not part of the port yet: those files are not in
the repository.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from facerecon_tpu_torch.utils.bfm import (raster_row_order,
                                           vertex_face_adjacency)

# the orthographic scale the static raster row order is built at (DECA's
# codes put s near 9 for a face that fills a 224-px crop); any order is
# correct, a close one keeps the band windows tight
RASTER_CAM_SCALE = 9.0
RAW = ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights",
       "parents", "faces", "uvcoords", "uvfaces", "lmk_faces_idx",
       "lmk_bary_coords", "dynamic_lmk_faces_idx", "dynamic_lmk_bary_coords",
       "albedo_mean", "albedo_basis")
RAW_DETAIL = ("fixed_uv_dis", "uv_face_eye_mask")
# DECA's dense grid margins (util.generate_triangles' margin_x, margin_y)
DENSE_MARGINS = (2, 5)


@dataclasses.dataclass(frozen=True)
class DetailAssets:
    """The detail model's arrays and the tables derived from them."""
    fixed_uv_dis: np.ndarray       # (S, S) float32
    uv_face_eye_mask: np.ndarray   # (S, S) float32
    texel_face: np.ndarray         # (S * S,) int32 UV face, -1 = none
    texel_bary: np.ndarray         # (S * S, 3) float32, 0 where none

    @property
    def uv_size(self) -> int:
        return self.fixed_uv_dis.shape[0]


def uv_texel_table(uvcoords, uvfaces, size: int):
    """(face (S * S,) int32, barycentrics (S * S, 3) float32): the UV
    face covering each texel centre and the barycentrics of its corners
    there (module docstring), computed in float64."""
    uv = np.asarray(uvcoords, np.float64)
    p = np.stack([uv[:, 0] * size, (1.0 - uv[:, 1]) * size], 1)[
        np.asarray(uvfaces)]                                  # (F, 3, 2)
    area = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
            - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0]))
    lo = np.clip(np.ceil(p.min(1) - 0.5), 0, None).astype(np.int64)
    hi = np.clip(np.floor(p.max(1) - 0.5), None, size - 1).astype(np.int64)
    n = np.clip(hi - lo + 1, 0, None)
    count = np.where(np.abs(area) > 1e-12, n[:, 0] * n[:, 1], 0)
    f = np.repeat(np.arange(len(p)), count)
    local = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count,
                                               count)
    ix = lo[f, 0] + local % n[f, 0]
    iy = lo[f, 1] + local // n[f, 0]
    qx, qy = ix + 0.5, iy + 0.5
    pf = p[f]

    def edge(a, b):
        return ((pf[:, b, 0] - pf[:, a, 0]) * (qy - pf[:, a, 1])
                - (pf[:, b, 1] - pf[:, a, 1]) * (qx - pf[:, a, 0]))
    w = np.stack([edge(1, 2), edge(2, 0), edge(0, 1)], 1) / area[f, None]
    cov = (w >= 0).all(1)
    texel = (iy * size + ix)[cov]
    f, w = f[cov], w[cov]
    best = np.full(size * size, len(p), np.int64)
    np.minimum.at(best, texel, f)
    win = f == best[texel]
    face = np.full(size * size, -1, np.int32)
    bary = np.zeros((size * size, 3), np.float32)
    face[texel[win]] = f[win]
    bary[texel[win]] = w[win]
    return face, bary



@dataclasses.dataclass(frozen=True)
class FLAMEAssets:
    """Frozen container of the FLAME and albedo arrays. Host-side numpy;
    uploaded once."""
    v_template: np.ndarray
    shapedirs: np.ndarray
    posedirs: np.ndarray
    J_regressor: np.ndarray
    lbs_weights: np.ndarray
    parents: np.ndarray
    faces: np.ndarray
    uvcoords: np.ndarray
    uvfaces: np.ndarray
    lmk_faces_idx: np.ndarray
    lmk_bary_coords: np.ndarray
    dynamic_lmk_faces_idx: np.ndarray
    dynamic_lmk_bary_coords: np.ndarray
    albedo_mean: np.ndarray
    albedo_basis: np.ndarray
    vertex_face_adj: np.ndarray    # (N, deg_max), F = pad
    raster_rows: np.ndarray        # (F', 3) raster row order, pads [0, 0, 0]
    raster_row_id: np.ndarray      # (F',) face id per row, F + 1 = pad
    detail: DetailAssets | None = None  # DECA's detail model, if given

    @property
    def n_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def albedo_size(self) -> int:
        """A: the published albedo's side (512)."""
        return int(round((self.albedo_mean.shape[0] // 3) ** 0.5))


def flame_assets(arrays: dict, image_size: int = 224) -> FLAMEAssets:
    """The pack from the raw arrays (RAW, and RAW_DETAIL where both are
    given), with the derived tables."""
    raw = {k: np.asarray(arrays[k]) for k in RAW}
    faces = raw["faces"]
    adj = vertex_face_adjacency(faces, raw["v_template"].shape[0])
    # raster_row_order projects through a pinhole; at a distance 1000x
    # the head's depth it is the orthographic camera at RASTER_CAM_SCALE
    dist = 100.0
    rows, row_id = raster_row_order(
        faces, raw["v_template"].reshape(-1), image_size=image_size,
        focal=RASTER_CAM_SCALE * image_size / 2.0 * dist,
        camera_distance=dist)
    detail = None
    if all(k in arrays for k in RAW_DETAIL):
        fixed, mask = (np.asarray(arrays[k], np.float32) for k in RAW_DETAIL)
        size = fixed.shape[0]
        if fixed.shape != (size, size) or mask.shape != (size, size):
            raise ValueError("fixed_uv_dis and uv_face_eye_mask must both "
                             "be (S, S)")
        face, bary = uv_texel_table(raw["uvcoords"], raw["uvfaces"], size)
        detail = DetailAssets(fixed_uv_dis=fixed, uv_face_eye_mask=mask,
                              texel_face=face, texel_bary=bary)
    return FLAMEAssets(**raw, vertex_face_adj=adj, raster_rows=rows,
                       raster_row_id=row_id, detail=detail)


def save_npz(path: str, assets: FLAMEAssets) -> None:
    """The raw arrays (RAW, and RAW_DETAIL with a detail pack); load_npz
    derives the tables again."""
    arrays = {k: getattr(assets, k) for k in RAW}
    if assets.detail is not None:
        arrays.update({k: getattr(assets.detail, k) for k in RAW_DETAIL})
    np.savez_compressed(path, **arrays)


def load_npz(path: str, image_size: int = 224) -> FLAMEAssets:
    with np.load(path) as z:
        return flame_assets({k: z[k] for k in RAW + RAW_DETAIL
                             if k in z.files}, image_size)
