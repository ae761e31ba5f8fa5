"""Video-file frame extraction for tracking (twin of
facerecon_tpu/data/video.py) — SURVEY.md §2 L6 ("video frame extraction
for tracking", workload config 5).

Decodes a video file with OpenCV and applies the same per-frame alignment
as data/folder.py, so `facerecon_tpu_torch.track --video clip.mp4
--video-landmarks clip_lmk.npy` consumes raw footage directly instead
of a pre-extracted frame folder. Landmarks arrive as ONE side file for
the whole clip ((T, 68, 2) `.npy`, or a text file of T*68 "x y" lines)
— per-frame side-cars don't fit the video workflow.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from facerecon_tpu_torch.config import FaceReconConfig
from facerecon_tpu_torch.data.folder import canonical_template68, five_from_68
from facerecon_tpu_torch.data.preprocess import (align_face,
                                                 similarity_transform,
                                                 warp_affine)


def load_video_landmarks(path: str, n_frames: int) -> np.ndarray:
    """(T, 68, 2) landmark track from a .npy or flat-text side file."""
    if path.endswith(".npy"):
        lmk = np.load(path).astype(np.float32)
    else:
        lmk = np.loadtxt(path, dtype=np.float32)
    lmk = lmk.reshape(-1, 68, 2)
    if lmk.shape[0] < n_frames:
        raise ValueError(
            f"{path}: {lmk.shape[0]} landmark frames < {n_frames} decoded "
            "video frames")
    return lmk[:n_frames]


def read_frames(path: str, max_frames: Optional[int] = None,
                stride: int = 1) -> np.ndarray:
    """Decode (T, H, W, 3) float32 RGB in [0, 1] from a video file."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "video decode needs opencv-python (cv2); extract frames to a "
            "folder and use --frames-dir instead") from e
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    frames = []
    idx = 0
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        if idx % stride == 0:
            frames.append(bgr[..., ::-1].astype(np.float32) / 255.0)
            if max_frames is not None and len(frames) >= max_frames:
                break
        idx += 1
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def load_video(path: str, cfg: FaceReconConfig,
               landmarks: Optional[str] = None, align: str = "68pt",
               assets=None, max_frames: Optional[int] = None,
               stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Video file -> (aligned frames (T, S, S, 3), landmarks (T, 68, 2)).

    Alignment modes match data/folder.py; "68pt"/"5pt" require the
    landmark side file, "none" resizes only (landmarks NaN if absent —
    the track driver then refuses, since its objective needs them).
    """
    if align not in ("5pt", "68pt", "none"):
        raise ValueError(f"unknown align mode {align!r}")
    raw = read_frames(path, max_frames=max_frames, stride=stride)
    t = raw.shape[0]
    if landmarks is not None:
        lmk = load_video_landmarks(landmarks, t)
    elif align != "none":
        raise ValueError(f"align={align!r} needs --video-landmarks "
                         "(a (T,68,2) .npy/.txt track for the clip)")
    else:
        lmk = np.full((t, 68, 2), np.nan, np.float32)
    size = cfg.image_size
    if align == "68pt":
        if assets is None:
            raise ValueError("68pt alignment needs the asset pack for its "
                             "canonical landmark layout")
        template = canonical_template68(assets, cfg)
    frames_out, lmk_out = [], []
    ones = np.ones((68, 1), np.float32)
    for i in range(t):
        img = raw[i]
        if align == "none":
            h, w = img.shape[:2]
            m = np.array([[size / w, 0, 0], [0, size / h, 0]], np.float32)
            frames_out.append(np.clip(warp_affine(img, m, size), 0, 1))
            lmk_out.append(lmk[i] * np.array([size / w, size / h],
                                             np.float32))
        elif align == "68pt":
            m = similarity_transform(lmk[i], template)
            frames_out.append(
                np.clip(warp_affine(img, m, size), 0, 1))
            lmk_out.append(np.concatenate([lmk[i], ones], axis=1) @ m.T)
        else:
            f, l = align_face(img, five_from_68(lmk[i]), size,
                              landmarks68=lmk[i])
            frames_out.append(f)
            lmk_out.append(l)
    return (np.stack(frames_out).astype(np.float32),
            np.stack(lmk_out).astype(np.float32))
