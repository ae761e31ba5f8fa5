"""GaussianAvatars' asset layer (Qian et al., arXiv:2312.02069;
github.com/ShenhanQian/GaussianAvatars, flame_gaussian_model.py).

An avatar is FLAME (the arrays its linear blend skinning reads, under
FLAME's names) and the 3D Gaussians rigged to it, under the names
GaussianAvatars' point_cloud.ply stores them (its `_xyz`, `_rotation`,
...), packed once on the host and uploaded a single time
(`ops/gavatar.device_avatar`):

  v_template (N, 3)        the template, GaussianAvatars' learned static
                           offsets folded in
  shapedirs (N, 3, S + E)  identity, then expression (300 + 100)
  posedirs (36, 3N)        J_regressor (5, N)     lbs_weights (N, 5)
  parents (5,)             faces (F, 3)
  binding (G,)             the face each Gaussian is bound to
  xyz (G, 3)               its mean in the face's frame, in units of the
                           face's scale
  rotation (G, 4)          its rotation in the face's frame, a quaternion
                           (w, x, y, z), normalised when used
  scaling (G, 3)           its log-scale, in units of the face's scale
  opacity (G,)             its opacity's logit
  features_dc (G, 1, 3), features_rest (G, 15, 3)
                           its colour's SH coefficients, degree 3

A loader for a trained avatar (point_cloud.ply and the tracked FLAME
parameters of NeRSemble's subjects) and for FLAME 2023's files is not
part of the port yet: those files are not in the repository.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FLAME_RAW = ("v_template", "shapedirs", "posedirs", "J_regressor",
             "lbs_weights", "parents", "faces")
GAUSS_RAW = ("binding", "xyz", "rotation", "scaling", "opacity",
             "features_dc", "features_rest")


@dataclasses.dataclass(frozen=True)
class AvatarAssets:
    """Host-side numpy arrays of one avatar (module docstring)."""
    v_template: np.ndarray
    shapedirs: np.ndarray
    posedirs: np.ndarray
    J_regressor: np.ndarray
    lbs_weights: np.ndarray
    parents: np.ndarray
    faces: np.ndarray
    binding: np.ndarray
    xyz: np.ndarray
    rotation: np.ndarray
    scaling: np.ndarray
    opacity: np.ndarray
    features_dc: np.ndarray
    features_rest: np.ndarray

    @property
    def n_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def n_gaussians(self) -> int:
        return self.binding.shape[0]


def avatar_assets(arrays: dict) -> AvatarAssets:
    """The pack from the raw arrays (FLAME_RAW and GAUSS_RAW); raises on a
    Gaussian bound to no face or on SH of another degree than 3."""
    raw = {k: np.asarray(arrays[k]) for k in FLAME_RAW + GAUSS_RAW}
    g = raw["binding"].shape[0]
    n_f = raw["faces"].shape[0]
    if g and (raw["binding"].min() < 0 or raw["binding"].max() >= n_f):
        raise ValueError(f"binding must index the {n_f} faces")
    want = {"xyz": (g, 3), "rotation": (g, 4), "scaling": (g, 3),
            "opacity": (g,), "features_dc": (g, 1, 3),
            "features_rest": (g, 15, 3)}
    for k, shape in want.items():
        if raw[k].shape != shape:
            raise ValueError(f"{k}: expected {shape} (SH degree 3), got "
                             f"{raw[k].shape}")
    return AvatarAssets(**raw)
