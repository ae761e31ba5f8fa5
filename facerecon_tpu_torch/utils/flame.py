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
orthographic scale of RASTER_CAM_SCALE). A loader for the published
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
    """The pack from the raw arrays (RAW), with the derived tables."""
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
    return FLAMEAssets(**raw, vertex_face_adj=adj, raster_rows=rows,
                       raster_row_id=row_id)


def save_npz(path: str, assets: FLAMEAssets) -> None:
    """The raw arrays (RAW); load_npz derives the tables again."""
    np.savez_compressed(path, **{k: getattr(assets, k) for k in RAW})


def load_npz(path: str, image_size: int = 224) -> FLAMEAssets:
    with np.load(path) as z:
        return flame_assets({k: z[k] for k in RAW}, image_size)
