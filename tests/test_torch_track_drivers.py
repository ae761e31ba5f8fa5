"""The reference's track cases on the port's tracking driver, at
tiny_config() on the CPU (plain versions of the kernels), with the
reference's bars: tests/test_fit_track_ckpt.py:79-135 (a crafted
checkpoint, joint and sequential) and tests/test_real_input_drivers.py:
56-130 (a PNG folder, an MJPG clip). The solves are held against the
reference's in tests/test_torch_track.py.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from facerecon_tpu_torch import track as T
from facerecon_tpu_torch.checkpoint import CheckpointManager
from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu_torch.data.video import load_video
from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry, device_bfm
from facerecon_tpu_torch.pipeline import make_train_pipeline
from facerecon_tpu_torch.utils.coeffs import split_coeff

torch.set_num_threads(2)


def _args(*argv):
    return T.parse_args(["--tiny", "--device", "cpu", *argv])


def _head_ckpt(tmp_path, cfg, assets, coeff, name):
    """A checkpoint whose zero-kernel head predicts `coeff` for every
    input (tests/test_fit_track_ckpt.py's crafted checkpoint)."""
    pipe = make_train_pipeline(cfg, assets, device="cpu")
    with torch.no_grad():
        pipe.model.head.bias.copy_(torch.from_numpy(coeff))
    d = str(tmp_path / name)
    CheckpointManager(d).save(0, {"model": pipe.model.state_dict(),
                                  "step": 0})
    return d


def test_track_trained_ckpt_recovers_geometry(tmp_path, cfg, assets):
    """tests/test_fit_track_ckpt.py:79 on the port: a checkpoint that
    predicts the sequence's base plus noise, then the joint solve must
    recover the per-frame GEOMETRY to half the stage-1 vertex error."""
    base = sample_coeffs(np.random.default_rng(3), cfg, 1)[0]
    noisy = base + 0.08 * np.random.default_rng(2).standard_normal(
        base.shape).astype(np.float32)
    ck = _head_ckpt(tmp_path, cfg, assets, noisy, "ck_track")
    report = T.run(_args("--frames", "6", "--refine-steps", "100",
                         "--ckpt", ck, "--seed", "3"))

    # the generating sequence of track.run(seed=3, frames=6)
    bfm = device_bfm(assets, "cpu")
    rng3 = np.random.default_rng(3)
    b2 = sample_coeffs(rng3, cfg, 1)[0]
    t_ax = np.linspace(0, 2 * np.pi, 6, dtype=np.float32)
    seq = np.tile(b2, (6, 1))
    sp = cfg.coeff_split
    seq[:, sp[0]:sp[1]] += (0.15 * np.sin(t_ax)[:, None]
                            * rng3.standard_normal((1, cfg.n_exp))
                            .astype(np.float32))
    seq[:, sp[2]] += 0.2 * np.sin(t_ax)

    def verts(c):
        return coeffs_to_geometry(split_coeff(torch.from_numpy(c), cfg),
                                  bfm, cfg).verts_world
    with torch.no_grad():
        stage1_vmae = float((verts(np.tile(noisy, (6, 1)))
                             - verts(seq)).abs().mean())
    assert report["vertex_mae"] < stage1_vmae * 0.5
    assert report["landmark_rmse_px"] < 1.0
    assert report["psnr_db"] > 24.0
    assert report["loss_last"] < report["loss_first"]
    assert report["frames"] == 6 and report["devices"] == 1
    assert np.isfinite(report["id_err"])


def test_track_sequential_warm_start(tmp_path, cfg, assets):
    """tests/test_fit_track_ckpt.py:126 on the port: the CNN predicts the
    BASE coefficients, so the per-frame refinement must recover the
    sweep."""
    base = sample_coeffs(np.random.default_rng(3), cfg, 1)[0]
    ck = _head_ckpt(tmp_path, cfg, assets, base, "ck_seq")
    report = T.run(_args("--frames", "6", "--refine-steps", "40",
                         "--ckpt", ck, "--seed", "3", "--sequential"))
    assert np.isfinite(report["loss_last"])
    assert report["psnr_db"] > 22.0
    assert report["landmark_rmse_px"] < 1.0
    assert report["vertex_mae"] < 0.04


def _sweep(cfg, assets, seed):
    """Four frames (numpy) of one face under a yaw sweep."""
    base = sample_coeffs(np.random.default_rng(seed), cfg, 1)[0]
    t_ax = np.linspace(0, 2 * np.pi, 4, dtype=np.float32)
    seq = np.tile(base, (4, 1))
    seq[:, cfg.coeff_split[2]] += 0.15 * np.sin(t_ax)
    return (t.numpy() for t in render_batch(seq, device_bfm(assets, "cpu"),
                                            cfg))


def test_track_from_disk_recovers(tmp_path, cfg, assets):
    """tests/test_real_input_drivers.py:56 on the port: frames and
    landmark side-cars from a PNG folder, aligned 68pt."""
    frames, lmk = _sweep(cfg, assets, 5)
    frames_dir = tmp_path / "frames"
    os.makedirs(frames_dir)
    for i in range(4):
        Image.fromarray((np.clip(frames[i], 0, 1) * 255).astype(
            np.uint8)).save(frames_dir / f"img_{i:03d}.png")
        np.savetxt(frames_dir / f"img_{i:03d}.txt", lmk[i], fmt="%.4f")
    out_dir = str(tmp_path / "track_out")
    rep = T.run(_args("--frames-dir", str(frames_dir), "--out", out_dir,
                      "--refine-steps", "80"))
    assert rep["frames"] == 4
    assert rep["loss_last"] < rep["loss_first"] * 0.5
    assert rep["landmark_rmse_px"] < 1.5
    assert rep["psnr_db"] > 19.0
    assert "vertex_mae" not in rep
    coeffs = np.load(os.path.join(out_dir, "tracked_coeffs.npy"))
    assert coeffs.shape == (4, cfg.n_coeff)
    assert np.isfinite(coeffs).all()
    assert np.load(os.path.join(out_dir, "tracked_landmarks.npy")).shape == (
        4, 68, 2)


def test_track_from_video_file(tmp_path, cfg, assets):
    """tests/test_real_input_drivers.py:84 on the port: an MJPG clip
    encoded with cv2 and one (T,68,2) landmark file, --align none."""
    cv2 = pytest.importorskip("cv2")
    frames, lmk = _sweep(cfg, assets, 9)
    path = str(tmp_path / "clip.avi")
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (w, h))
    assert vw.isOpened(), "cv2 MJPG writer unavailable"
    for i in range(4):
        vw.write((np.clip(frames[i], 0, 1) * 255).astype(np.uint8)[..., ::-1])
    vw.release()
    lmk_path = str(tmp_path / "clip_lmk.npy")
    np.save(lmk_path, lmk)

    dec, dec_lmk = load_video(path, cfg, landmarks=lmk_path, align="none")
    assert dec.shape == (4, cfg.image_size, cfg.image_size, 3)
    assert np.abs(dec - frames).mean() < 0.03
    np.testing.assert_allclose(dec_lmk, lmk, atol=1e-3)

    out_dir = str(tmp_path / "video_track_out")
    rep = T.run(_args("--video", path, "--video-landmarks", lmk_path,
                      "--align", "none", "--out", out_dir,
                      "--refine-steps", "80"))
    assert rep["frames"] == 4
    assert rep["loss_last"] < rep["loss_first"] * 0.5
    assert rep["landmark_rmse_px"] < 2.0
    coeffs = np.load(os.path.join(out_dir, "tracked_coeffs.npy"))
    assert coeffs.shape == (4, cfg.n_coeff)
    assert np.isfinite(coeffs).all()
