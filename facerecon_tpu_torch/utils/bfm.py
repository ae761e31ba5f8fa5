"""BFM (Basel Face Model) asset layer — SURVEY.md §3 C1.

The reference loads MATLAB `.mat` BFM files at runtime; the TPU rebuild packs
the arrays once into a `.npz` and loads them as frozen float32/int32 numpy
arrays that are uploaded to device a single time (SURVEY.md §2 K1).

Real BFM data is licensed and absent in this environment, so the framework is
validated against a *synthetic* generator that produces a face-like half-sphere
mesh with random-orthonormal PCA bases of the configured shapes
(SURVEY.md §8 step 1). Any real basis of the right shapes drops in via the
same `.npz` pack.

Array shapes (N vertices, F triangles, K* basis sizes):
  mean_shape (3N,)   id_basis (3N,K_id)   exp_basis (3N,K_exp)
  mean_tex   (3N,)   tex_basis (3N,K_tex)
  sigma_id (K_id,)   sigma_exp (K_exp,)   sigma_tex (K_tex,)
  faces (F,3) int32  landmark_index (68,) int32   skin_mask (N,) f32
"""

from __future__ import annotations

import dataclasses

import numpy as np

from facerecon_tpu_torch.config import FaceReconConfig


@dataclasses.dataclass(frozen=True)
class BFMAssets:
    """Frozen container of BFM arrays. Host-side numpy; uploaded once."""
    mean_shape: np.ndarray      # (3N,) f32
    id_basis: np.ndarray        # (3N, K_id) f32
    exp_basis: np.ndarray       # (3N, K_exp) f32
    mean_tex: np.ndarray        # (3N,) f32, RGB in [0, 255]
    tex_basis: np.ndarray       # (3N, K_tex) f32
    sigma_id: np.ndarray        # (K_id,) f32 — PCA eigenvalue sqrt
    sigma_exp: np.ndarray       # (K_exp,) f32
    sigma_tex: np.ndarray       # (K_tex,) f32
    faces: np.ndarray           # (F, 3) int32, CCW
    landmark_index: np.ndarray  # (68,) int32
    skin_mask: np.ndarray       # (N,) f32 in [0,1]
    vertex_face_adj: np.ndarray # (N, deg_max) int32, F = padding sentinel
    vertex_corner_adj: np.ndarray  # (N, deg_max) int32, 3F = pad: flat
                                   # (face*3+slot) corner ids per vertex
    face_adj_slot: np.ndarray   # (F, 3) int32: flat (v*deg_max + rank)
                                # position of each face corner in the
                                # vertex adjacency table
    raster_rows: np.ndarray     # (F', 3) int32 raster row order: faces
                                # sorted by mean-shape (y-bin, x) with each
                                # bin padded to a 128 multiple; pads [0,0,0]
                                # (degenerate, never cover). See
                                # raster_row_order.
    raster_row_id: np.ndarray   # (F',) int32 original face id per raster
                                # row; pads hold F+1 (sentinel no pixel can
                                # select)

    @property
    def n_vertices(self) -> int:
        return self.mean_shape.shape[0] // 3

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]


def save_npz(path: str, assets: BFMAssets) -> None:
    np.savez_compressed(path, **dataclasses.asdict(assets))


def load_npz(path: str) -> BFMAssets:
    """Load an asset pack. The adjacency tables (vertex_face_adj,
    vertex_corner_adj, face_adj_slot) and the raster row order
    (raster_rows, raster_row_id) are derived data — packs saved before
    they existed, or prepared externally per the drop-in contract, may omit
    them; they are recomputed from `faces` (+ `mean_shape`) here."""
    with np.load(path) as z:
        fields = {f.name: z[f.name]
                  for f in dataclasses.fields(BFMAssets) if f.name in z}
    adj_names = ("vertex_face_adj", "vertex_corner_adj", "face_adj_slot")
    if any(name not in fields for name in adj_names):
        n = fields["mean_shape"].shape[0] // 3
        adj, corner_adj, face_slot = vertex_face_adjacency(
            fields["faces"], n, with_corners=True)
        fields.update(vertex_face_adj=adj, vertex_corner_adj=corner_adj,
                      face_adj_slot=face_slot)
    if "raster_rows" not in fields or "raster_row_id" not in fields:
        rows, row_id = raster_row_order(fields["faces"],
                                        fields["mean_shape"])
        fields.update(raster_rows=rows, raster_row_id=row_id)
    return BFMAssets(**fields)


def raster_row_order(faces: np.ndarray, mean_shape: np.ndarray,
                     bin_px: float = 2.0, chunk: int = 128,
                     image_size: int = 224, focal: float = 1015.0,
                     camera_distance: float = 10.0):
    """Static raster row order: faces sorted by mean-shape screen
    (y-bin, x centroid), each bin padded to a `chunk` multiple.

    The Pallas rasterizer's per-(band, column) candidate windows are
    CONTIGUOUS chunk spans (ops/binning.bin_triangles_static). Two things
    make those spans tight: x-ascending order inside each y bin (a column
    intersects one short run), and chunk-aligned bins (no chunk straddles a
    bin seam — seam chunks span the full face width and drag every
    column's contiguous span wide; measured p90 chunk x-extent 114px vs
    p50 23px at 224px without alignment). The order is built ONCE from the
    mean shape at the canonical zero pose — per-pose windows are computed
    from actual positions at run time, so a bad order only loosens
    windows, never correctness. Pads are [0,0,0] (zero area, never cover)
    with row id F+1 (never selected).

    Returns (raster_rows (F',3) int32, raster_row_id (F',) int32),
    F' = F rounded up per bin, typically < 1.05 F.
    """
    f = faces.shape[0]
    mean = mean_shape.reshape(-1, 3)
    z = camera_distance - mean[:, 2]
    u = focal * mean[:, 0] / z + image_size / 2.0
    v = image_size / 2.0 - focal * mean[:, 1] / z
    fv = v[faces]
    fu = u[faces]
    ybin = np.floor(fv.min(axis=1) / bin_px).astype(np.int64)
    order = np.argsort(ybin * (2.0 ** 32) + fu.mean(axis=1), kind="stable")
    yb_sorted = ybin[order]
    # merge consecutive y bins below ~3 chunks: tiny bins pay the full
    # chunk-alignment pad for no pruning gain (a small mesh's columns are
    # cheap anyway); big meshes keep their natural 2px bins
    min_bin = 3 * chunk
    ids = []
    pend = []
    pend_n = 0
    for b in np.unique(yb_sorted):        # ascending y
        idx = order[yb_sorted == b]
        pend.append(idx)
        pend_n += len(idx)
        if pend_n >= min_bin:
            ids.append(np.concatenate(pend))
            ids.append(np.full((-pend_n) % chunk, -1, np.int64))
            pend, pend_n = [], 0
    if pend_n:
        ids.append(np.concatenate(pend))
        ids.append(np.full((-pend_n) % chunk, -1, np.int64))
    row = np.concatenate(ids) if ids else np.zeros((0,), np.int64)
    pad = row < 0
    rows = np.where(pad[:, None], 0, faces[np.clip(row, 0, None)])
    row_id = np.where(pad, f + 1, row)
    return rows.astype(np.int32), row_id.astype(np.int32)


def vertex_face_adjacency(faces: np.ndarray, n_vertices: int,
                          deg_cap: int | None = None,
                          with_corners: bool = False):
    """(N, deg_max) face ids adjacent to each vertex; padded with F.

    Converts the per-frame normals scatter (segment_sum, slow on TPU) into a
    fixed gather: vertex normal = sum of adjacent face normals. deg_max is
    the true maximum vertex degree by default so the gather sums ALL adjacent
    faces (matching the oracle's segment_sum exactly); pass deg_cap only to
    bound gather cost on meshes with a pathological-degree vertex, in which
    case truncation is reported loudly rather than silently.

    with_corners=True additionally returns:
      vertex_corner_adj (N, deg_max): flat face*3+slot corner ids (pad 3F)
        — the gather that replaces the render-record pack's backward
        scatter;
      face_adj_slot (F, 3): each corner's flat v*deg_max+rank position in
        the adjacency table — the gather that replaces the normals
        accumulation's backward scatter.
    """
    f = faces.shape[0]
    v = faces.reshape(-1).astype(np.int64)        # (3F,)
    f_ids = np.repeat(np.arange(f, dtype=np.int64), 3)
    order = np.argsort(v, kind="stable")
    v_s, f_s = v[order], f_ids[order]
    counts = np.bincount(v_s, minlength=n_vertices)
    deg_true = max(int(counts.max()), 1)
    deg_max = deg_true if deg_cap is None else min(deg_true, int(deg_cap))
    if deg_max < deg_true:
        import warnings
        warnings.warn(
            f"vertex_face_adjacency: deg_cap={deg_cap} truncates "
            f"{int((counts > deg_max).sum())} vertices (max degree "
            f"{deg_true}); vertex normals will diverge from the oracle "
            "at those vertices", stacklevel=2)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(3 * f) - starts[v_s]
    keep = rank < deg_max
    adj = np.full((n_vertices, deg_max), f, dtype=np.int32)
    adj[v_s[keep], rank[keep]] = f_s[keep].astype(np.int32)
    if not with_corners:
        return adj
    corner_ids = order  # corner flat index (face*3+slot) sorted like v_s
    corner_adj = np.full((n_vertices, deg_max), 3 * f, dtype=np.int32)
    corner_adj[v_s[keep], rank[keep]] = corner_ids[keep].astype(np.int32)
    face_slot = np.zeros((f, 3), dtype=np.int32)
    face_slot.reshape(-1)[corner_ids[keep]] = (
        v_s[keep] * deg_max + rank[keep]).astype(np.int32)
    return adj, corner_adj, face_slot


def _grid_dims(n_target: int) -> tuple[int, int]:
    """Rows/cols of the half-sphere grid closest to (but >=) n_target."""
    r = int(np.ceil(np.sqrt(n_target)))
    c = int(np.ceil(n_target / r))
    return r, c


def _orthonormal_basis(rng: np.ndarray, rows: int, cols: int) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((rows, cols)))
    return np.ascontiguousarray(q, dtype=np.float32)


def synthetic_bfm(cfg: FaceReconConfig, seed: int = 0) -> BFMAssets:
    """Face-like half-sphere mesh + random-orthonormal PCA bases.

    Vertex count is the grid size nearest cfg.n_vertices (shapes are read from
    the asset downstream, so an off-by-a-few count is fine); triangle count
    follows from the grid. Geometry sits in a ~0.9-radius ball at the origin
    so the default camera (distance 10, focal 1015 @224) frames it.
    """
    rng = np.random.default_rng(seed)
    rows, cols = _grid_dims(cfg.n_vertices)
    n = rows * cols

    lat = np.linspace(-0.72, 0.72, rows) * np.pi / 2
    lon = np.linspace(-0.72, 0.72, cols) * np.pi / 2
    lat_g, lon_g = np.meshgrid(lat, lon, indexing="ij")
    radius = 0.9
    x = radius * np.cos(lat_g) * np.sin(lon_g)
    y = radius * np.sin(lat_g)
    z = radius * np.cos(lat_g) * np.cos(lon_g)
    # mild ellipsoid squash: faces are taller than wide, shallower than round
    verts = np.stack([x * 0.85, y, z * 0.75], axis=-1).reshape(n, 3)
    mean_shape = verts.reshape(-1).astype(np.float32)

    # triangulate the grid, CCW as seen from +z (camera side)
    idx = np.arange(n).reshape(rows, cols)
    v00 = idx[:-1, :-1].reshape(-1)
    v01 = idx[:-1, 1:].reshape(-1)
    v10 = idx[1:, :-1].reshape(-1)
    v11 = idx[1:, 1:].reshape(-1)
    # interleave the two triangles of each quad so the face list is
    # spatially coherent in mesh-row-major order (the sort-free band binning
    # of ops/binning.py relies on coherent orderings)
    faces = np.stack(
        [np.stack([v00, v01, v11], axis=-1),
         np.stack([v00, v11, v10], axis=-1)], axis=1
    ).reshape(-1, 3).astype(np.int32)

    # smooth skin-tone texture with low-frequency variation, RGB in [0,255]
    base = np.array([204.0, 164.0, 140.0], dtype=np.float32)
    wave = (np.sin(3.1 * lat_g) * np.cos(2.3 * lon_g)).reshape(n, 1)
    mean_tex = np.clip(base[None, :] + 25.0 * wave, 0, 255)
    mean_tex = mean_tex.reshape(-1).astype(np.float32)

    # random orthonormal bases scaled so unit-sigma coeffs deform mildly
    id_basis = _orthonormal_basis(rng, 3 * n, cfg.n_id) * 0.2
    exp_basis = _orthonormal_basis(rng, 3 * n, cfg.n_exp) * 0.1
    tex_basis = _orthonormal_basis(rng, 3 * n, cfg.n_tex) * 20.0

    decay = lambda k: (1.0 / np.sqrt(1.0 + np.arange(k))).astype(np.float32)
    sigma_id, sigma_exp, sigma_tex = (
        decay(cfg.n_id), decay(cfg.n_exp), decay(cfg.n_tex))

    # 68 landmark vertices spread over the central face region of the grid
    lm_rows = np.linspace(rows * 0.2, rows * 0.8, 8).astype(np.int64)
    lm_cols = np.linspace(cols * 0.15, cols * 0.85, 9).astype(np.int64)
    lm_grid = idx[np.ix_(lm_rows, lm_cols)].reshape(-1)[:68]
    landmark_index = np.ascontiguousarray(lm_grid, dtype=np.int32)

    # skin mask: 1 in the central region, soft falloff at the rim
    rim = np.minimum.reduce([
        lat_g - lat[0], lat[-1] - lat_g, lon_g - lon[0], lon[-1] - lon_g])
    skin_mask = np.clip(rim.reshape(n) / 0.2, 0.0, 1.0).astype(np.float32)

    adj, corner_adj, face_slot = vertex_face_adjacency(
        faces, n, with_corners=True)
    rows_r, row_id = raster_row_order(faces, mean_shape)
    return BFMAssets(
        mean_shape=mean_shape, id_basis=id_basis, exp_basis=exp_basis,
        mean_tex=mean_tex, tex_basis=tex_basis,
        sigma_id=sigma_id, sigma_exp=sigma_exp, sigma_tex=sigma_tex,
        faces=faces, landmark_index=landmark_index, skin_mask=skin_mask,
        vertex_face_adj=adj, vertex_corner_adj=corner_adj,
        face_adj_slot=face_slot, raster_rows=rows_r, raster_row_id=row_id)
