"""Data pre-processing / alignment (a copy of
facerecon_tpu/data/preprocess.py) — SURVEY.md §3 C18.

Host-side numpy/cv2 code: aligns a face image to the canonical
image_size x image_size crop from 5-point detections via a least-squares
similarity transform, and converts 68-point landmark files between original
and crop coordinates. No TF; plain numpy feeding the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

# canonical 5-point template (left eye, right eye, nose, mouth corners) for a
# 224x224 crop — the widely used ArcFace-style layout scaled from 112.
_TEMPLATE_112 = np.array([
    [38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
    [41.5493, 92.3655], [70.7299, 92.2041]], dtype=np.float32)


def canonical_template(image_size: int) -> np.ndarray:
    return _TEMPLATE_112 * (image_size / 112.0)


def similarity_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity (scale+rot+trans) src->dst as a 2x3 matrix.

    Umeyama closed form, numpy-only so it runs without cv2.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    diag = np.diag([1.0, d])
    var_s = (sc ** 2).sum() / src.shape[0]
    scale = np.trace(np.diag(s) @ diag) / var_s
    rot = scale * (u @ diag @ vt)
    t = mu_d - rot @ mu_s
    return np.concatenate([rot, t[:, None]], axis=1).astype(np.float32)


def warp_affine(image: np.ndarray, matrix: np.ndarray,
                out_size: int) -> np.ndarray:
    """Apply a 2x3 affine warp. Uses cv2 when present, else a numpy
    inverse-mapping bilinear fallback (slow, test-grade)."""
    if _HAS_CV2:
        return cv2.warpAffine(image, matrix, (out_size, out_size),
                              flags=cv2.INTER_LINEAR)
    a = np.concatenate([matrix, [[0, 0, 1]]], axis=0).astype(np.float64)
    inv = np.linalg.inv(a)
    ys, xs = np.mgrid[0:out_size, 0:out_size].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    h, w = image.shape[:2]
    x0 = np.clip(np.floor(sx).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, h - 2)
    fx = np.clip(sx - x0, 0, 1)[..., None]
    fy = np.clip(sy - y0, 0, 1)[..., None]
    img = image if image.ndim == 3 else image[..., None]
    out = ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
           + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))
    oob = (sx < 0) | (sx > w - 1) | (sy < 0) | (sy > h - 1)
    out[oob] = 0
    return out if image.ndim == 3 else out[..., 0]


def align_face(image: np.ndarray, landmarks5: np.ndarray,
               image_size: int = 224,
               landmarks68: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Align a face to the canonical crop from 5-point detections.

    image: (H,W,3) uint8/float; landmarks5: (5,2) pixel coords.
    Returns (aligned float32 [0,1] (S,S,3), transformed 68-pt landmarks).
    """
    m = similarity_transform(landmarks5, canonical_template(image_size))
    aligned = warp_affine(np.asarray(image, np.float32), m, image_size)
    if aligned.max() > 1.5:  # uint8-range input
        aligned = aligned / 255.0
    lmk_out = None
    if landmarks68 is not None:
        ones = np.ones((landmarks68.shape[0], 1), np.float32)
        pts = np.concatenate([landmarks68.astype(np.float32), ones], axis=1)
        lmk_out = (pts @ m.T).astype(np.float32)
    return np.clip(aligned, 0.0, 1.0).astype(np.float32), lmk_out
