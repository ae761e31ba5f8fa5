"""Frozen copies of the port's workload builders and of its synthetic
mesh maker.

The benchmark's yardstick may not change when the program does, so it
keeps its own copies: the images and landmarks the port's bench.py
draws (`headline_images`, `train_inputs`), the coefficient sampler of
data/synthetic.py (`sample_coeffs`), and the raw arrays of
utils/bfm.synthetic_bfm (`synthetic_mesh`: the face-like grid and its
random orthonormal bases, without the tables the program derives from
them). tests/test_perfbench_frozen.py holds each against the port's.
"""

from __future__ import annotations

import numpy as np


def headline_images(batch: int, size: int, seed: int = 0) -> np.ndarray:
    """Uniform [0, 1) float32 images (B, S, S, 3) from default_rng(seed)."""
    return np.random.default_rng(seed).random(
        (batch, size, size, 3)).astype(np.float32)


def train_inputs(chunk: int, batch: int, size: int, seed: int = 0):
    """(chunk, batch, ...) images and 68 landmarks, float32, drawn in
    this order from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    images = rng.random((chunk, batch, size, size, 3)).astype(np.float32)
    lmk = (rng.random((chunk, batch, 68, 2)) * size).astype(np.float32)
    return images, lmk


def coeff_split(sizes: dict) -> tuple:
    """Cumulative split points of [id | exp | tex | angles | gamma | t]."""
    out, acc = [], 0
    for k in ("n_id", "n_exp", "n_tex", "n_angles", "n_gamma"):
        acc += sizes[k]
        out.append(acc)
    return tuple(out)


def n_coeff(sizes: dict) -> int:
    return sum(sizes[k] for k in ("n_id", "n_exp", "n_tex", "n_angles",
                                  "n_gamma", "n_trans"))


def sample_coeffs(rng: np.random.Generator, sizes: dict, batch: int,
                  scale: float = 0.3) -> np.ndarray:
    """Posed, lit coefficient draws (B, n_coeff): normal * scale, mild
    pose, small translation, near channel-balanced SH lighting."""
    c = (rng.standard_normal((batch, n_coeff(sizes))) * scale).astype(
        np.float32)
    s = coeff_split(sizes)
    c[:, s[2]:s[3]] *= 0.3
    c[:, s[4]:] *= 0.1
    shared = rng.standard_normal((batch, 1, 9)) * 0.15
    jitter = rng.standard_normal((batch, 3, 9)) * 0.02
    c[:, s[3]:s[4]] = (shared + jitter).reshape(batch, 27).astype(np.float32)
    return c


def coeff_spread(sizes: dict, scale: float = 0.3) -> dict:
    """Each group's mean and standard deviation under sample_coeffs:
    every entry has mean 0; gamma's std is that of shared + jitter."""
    gamma = float(np.hypot(0.15, 0.02))
    return {"id": (0.0, scale), "exp": (0.0, scale), "tex": (0.0, scale),
            "angles": (0.0, 0.3 * scale), "gamma": (0.0, gamma),
            "trans": (0.0, 0.1 * scale)}


GROUPS = ("id", "exp", "tex", "angles", "gamma", "trans")


def group_slices(sizes: dict) -> dict:
    bounds = (0, *coeff_split(sizes), n_coeff(sizes))
    return {g: slice(lo, hi) for g, lo, hi in zip(GROUPS, bounds[:-1],
                                                  bounds[1:])}


def _grid_dims(n_target: int):
    r = int(np.ceil(np.sqrt(n_target)))
    return r, int(np.ceil(n_target / r))


def _orthonormal_basis(rng, rows: int, cols: int) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((rows, cols)))
    return np.ascontiguousarray(q, dtype=np.float32)


def synthetic_mesh(sizes: dict, seed: int = 0) -> dict:
    """The raw arrays of a face-like half-sphere grid mesh with random
    orthonormal PCA bases: mean_shape (3N,), id/exp/tex bases (3N, K),
    mean_tex (3N,) in [0, 255], sigma_* (K,), faces (F, 3) int32 CCW,
    landmark_index (68,) int32, skin_mask (N,). N is the grid nearest
    n_vertices; F follows from the grid."""
    rng = np.random.default_rng(seed)
    rows, cols = _grid_dims(sizes["n_vertices"])
    n = rows * cols
    lat = np.linspace(-0.72, 0.72, rows) * np.pi / 2
    lon = np.linspace(-0.72, 0.72, cols) * np.pi / 2
    lat_g, lon_g = np.meshgrid(lat, lon, indexing="ij")
    radius = 0.9
    x = radius * np.cos(lat_g) * np.sin(lon_g)
    y = radius * np.sin(lat_g)
    z = radius * np.cos(lat_g) * np.cos(lon_g)
    verts = np.stack([x * 0.85, y, z * 0.75], axis=-1).reshape(n, 3)
    mean_shape = verts.reshape(-1).astype(np.float32)
    idx = np.arange(n).reshape(rows, cols)
    v00 = idx[:-1, :-1].reshape(-1)
    v01 = idx[:-1, 1:].reshape(-1)
    v10 = idx[1:, :-1].reshape(-1)
    v11 = idx[1:, 1:].reshape(-1)
    faces = np.stack(
        [np.stack([v00, v01, v11], axis=-1),
         np.stack([v00, v11, v10], axis=-1)], axis=1
    ).reshape(-1, 3).astype(np.int32)
    base = np.array([204.0, 164.0, 140.0], dtype=np.float32)
    wave = (np.sin(3.1 * lat_g) * np.cos(2.3 * lon_g)).reshape(n, 1)
    mean_tex = np.clip(base[None, :] + 25.0 * wave, 0, 255)
    mean_tex = mean_tex.reshape(-1).astype(np.float32)
    id_basis = _orthonormal_basis(rng, 3 * n, sizes["n_id"]) * 0.2
    exp_basis = _orthonormal_basis(rng, 3 * n, sizes["n_exp"]) * 0.1
    tex_basis = _orthonormal_basis(rng, 3 * n, sizes["n_tex"]) * 20.0

    def decay(k):
        return (1.0 / np.sqrt(1.0 + np.arange(k))).astype(np.float32)

    lm_rows = np.linspace(rows * 0.2, rows * 0.8, 8).astype(np.int64)
    lm_cols = np.linspace(cols * 0.15, cols * 0.85, 9).astype(np.int64)
    lm_grid = idx[np.ix_(lm_rows, lm_cols)].reshape(-1)[:68]
    rim = np.minimum.reduce([
        lat_g - lat[0], lat[-1] - lat_g, lon_g - lon[0], lon[-1] - lon_g])
    return dict(
        mean_shape=mean_shape, id_basis=id_basis, exp_basis=exp_basis,
        mean_tex=mean_tex, tex_basis=tex_basis,
        sigma_id=decay(sizes["n_id"]), sigma_exp=decay(sizes["n_exp"]),
        sigma_tex=decay(sizes["n_tex"]), faces=faces,
        landmark_index=np.ascontiguousarray(lm_grid, dtype=np.int32),
        skin_mask=np.clip(rim.reshape(n) / 0.2, 0.0, 1.0).astype(
            np.float32))
