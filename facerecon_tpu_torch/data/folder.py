"""Image-folder dataset with landmark supervision (twin of
facerecon_tpu/data/folder.py) — SURVEY.md §3 C18
("load landmark supervision files; batching", alignment "5-point or
68-point").

Layout expected under the root directory (the reference family's usual
detection side-car convention):

    root/
      img_0001.png            (or .jpg)
      img_0001.txt            68x2 landmark detections, "x y" per line
      img_0001_5p.txt         optional 5x2 detections (else derived from 68)

Alignment modes:
  "5pt"  — similarity transform from 5 points to the canonical ArcFace-
           style template (data/preprocess.py);
  "68pt" — similarity transform fitted on ALL 68 detections against the
           asset pack's canonical 68-point layout (the BFM's landmark
           vertices projected at the neutral pose) — more stable than 5
           points when detections are noisy;
  "none" — images are already aligned crops; only resizing is applied.

Batches mirror data/synthetic.py's (images, landmarks68, coeffs=None)
interface so facerecon_tpu_torch.train consumes either source unchanged.
Images are numpy on the host; train.py stages them onto the device.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from facerecon_tpu_torch.config import FaceReconConfig
from facerecon_tpu_torch.data.preprocess import (align_face,
                                                 similarity_transform,
                                                 warp_affine)

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")

# 68-point -> 5-point reduction: eye centers, nose tip, mouth corners
# (iBUG-68 indexing, the reference family's detection convention)
_L_EYE = slice(36, 42)
_R_EYE = slice(42, 48)
_NOSE = 30
_MOUTH_L = 48
_MOUTH_R = 54


def five_from_68(lmk68: np.ndarray) -> np.ndarray:
    return np.stack([
        lmk68[_L_EYE].mean(0), lmk68[_R_EYE].mean(0),
        lmk68[_NOSE], lmk68[_MOUTH_L], lmk68[_MOUTH_R]
    ]).astype(np.float32)


def canonical_template68(assets, cfg: FaceReconConfig) -> np.ndarray:
    """The asset pack's own canonical 68-point layout: landmark vertices of
    the mean face projected at the neutral pose (no scipy, no external
    template — works for ANY drop-in basis)."""
    mean = assets.mean_shape.reshape(-1, 3)[assets.landmark_index]
    zp = cfg.camera_distance - mean[:, 2]
    u = cfg.focal * mean[:, 0] / zp + cfg.center
    v = cfg.center - cfg.focal * mean[:, 1] / zp
    return np.stack([u, v], axis=1).astype(np.float32)


def load_landmarks(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float32).reshape(-1, 2)


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


class FolderDataset:
    """Folder of (image, 68-landmark) pairs with on-the-fly alignment."""

    def __init__(self, root: str, cfg: FaceReconConfig,
                 align: str = "68pt", assets=None):
        if align not in ("5pt", "68pt", "none"):
            raise ValueError(f"unknown align mode {align!r}")
        if align == "68pt" and assets is None:
            raise ValueError("68pt alignment needs the asset pack for its "
                             "canonical landmark layout")
        self.cfg = cfg
        self.align = align
        self._template68 = (canonical_template68(assets, cfg)
                            if align == "68pt" else None)
        self.items = []
        for fn in sorted(os.listdir(root)):
            stem, ext = os.path.splitext(fn)
            if ext.lower() not in _IMG_EXTS or stem.endswith("_5p"):
                continue
            lmk_path = os.path.join(root, stem + ".txt")
            if not os.path.exists(lmk_path):
                if align != "none":
                    raise FileNotFoundError(
                        f"no landmark file for {fn}: expected {lmk_path}")
                lmk_path = None   # pre-aligned crops may ship bare images
            self.items.append((os.path.join(root, fn), lmk_path,
                               os.path.join(root, stem + "_5p.txt")))
        if not self.items:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self) -> int:
        return len(self.items)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (aligned image (S,S,3) f32 [0,1], aligned landmarks (68,2))."""
        img_path, lmk_path, p5_path = self.items[idx]
        image = _load_image(img_path)
        # bare pre-aligned crops (align="none", no side-car): landmarks NaN
        # so downstream landmark losses are an explicit error to request
        lmk68 = (load_landmarks(lmk_path) if lmk_path is not None
                 else np.full((68, 2), np.nan, np.float32))
        size = self.cfg.image_size
        if self.align == "none":
            h, w = image.shape[:2]
            sx, sy = size / w, size / h
            m = np.array([[sx, 0, 0], [0, sy, 0]], np.float32)
            out = warp_affine(image, m, size)
            return (np.clip(out, 0, 1).astype(np.float32),
                    (lmk68 * np.array([sx, sy], np.float32)))
        if self.align == "68pt":
            m = similarity_transform(lmk68, self._template68)
            out = warp_affine(image, m, size)
            ones = np.ones((68, 1), np.float32)
            pts = np.concatenate([lmk68, ones], axis=1) @ m.T
            return (np.clip(out, 0, 1).astype(np.float32),
                    pts.astype(np.float32))
        lmk5 = (load_landmarks(p5_path) if os.path.exists(p5_path)
                else five_from_68(lmk68))
        return align_face(image, lmk5, size, landmarks68=lmk68)

    def stems(self) -> list:
        """Basenames (no extension) in filename order — output naming for
        the fit/track drivers."""
        return [os.path.splitext(os.path.basename(it[0]))[0]
                for it in self.items]

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every item in filename order -> (images (N,S,S,3) f32,
        landmarks68 (N,68,2)). The ORDERED interface for the fit (photo in
        -> mesh out) and track (frame sequence) drivers, which must not
        shuffle."""
        pairs = [self.load(i) for i in range(len(self.items))]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))

    def batches(self, batch: int, seed: int = 0, epochs: Optional[int] = None,
                shard: Optional[Callable] = None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, None]]:
        """Endless (or epochs-bounded) shuffled (images, lmk68, None)
        batches, same interface as data/synthetic.synthetic_batches.

        shard: maps each global batch's item indices to the part this
        process loads (parallel/mesh.shard_batch), before any image is
        decoded; every rank shuffles the same order from `seed`."""
        if len(self.items) < batch:
            raise ValueError(
                f"dataset has {len(self.items)} items < batch size {batch}: "
                "batches() would yield nothing (drop-last batching)")
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.items))
            for i in range(0, len(order) - batch + 1, batch):
                idx = order[i:i + batch]
                if shard is not None:
                    idx = shard(idx)
                pairs = [self.load(int(j)) for j in idx]
                yield (np.stack([p[0] for p in pairs]),
                       np.stack([p[1] for p in pairs]), None)
            epoch += 1
