"""The port's tracking driver (track.py, data/video.py) on the CPU at
tiny_config(), against the JAX reference on the same inputs, plus the
reference's CLI case (tests/test_drivers_cli.py:41-49) and the video
loader's errors. The reference's other track cases run on the port in
tests/test_torch_track_drivers.py.

On the CPU the reference renders through rasterize_tiled (Pallas does not
run there) and the port through the plain versions of its kernels. Bars
against the reference (the fit's, tests/test_torch_drivers.py): each
loss within 1e-4 relative, and every coefficient within 2 x lr (Adam
moves a coordinate whose gradient is ~0 by up to lr a step in either
direction); the EMA, _assemble and _decompose equal the reference's.
"""

import argparse

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from facerecon_tpu import track as ref_track
from facerecon_tpu.ops.geometry import device_bfm as ref_device_bfm

from facerecon_tpu_torch import track as T
from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu_torch.data.video import load_video
from facerecon_tpu_torch.ops.geometry import device_bfm

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sequence(cfg, assets):
    """Four frames of one face under a yaw sweep (numpy), and a start
    halfway to its coefficients."""
    rng = np.random.default_rng(2)
    base = sample_coeffs(rng, cfg, 1)[0]
    seq = np.tile(base, (4, 1))
    seq[:, cfg.coeff_split[2]] += np.linspace(-0.1, 0.1, 4).astype(
        np.float32)
    frames, lmk = (t.numpy() for t in render_batch(
        seq, device_bfm(assets, "cpu"), cfg))
    return frames, lmk, (seq * 0.5).astype(np.float32)


# --- the solves against the reference ---

def test_joint_solve_matches_reference(cfg, assets, sequence):
    frames, lmk, start = sequence
    lr, steps = 5e-3, 10
    ref_tp, ref_losses = ref_track.make_refine_fn(cfg, steps, lr)(
        ref_track._decompose(jnp.asarray(start), cfg), ref_device_bfm(assets),
        jnp.asarray(frames), jnp.asarray(lmk))
    tp, losses = T.make_refine_fn(cfg, steps, lr)(
        T._decompose(torch.from_numpy(start), cfg),
        device_bfm(assets, "cpu"), frames, lmk)
    ref_losses = np.asarray(ref_losses)
    assert losses.shape == (steps,)
    np.testing.assert_allclose(losses.numpy(), ref_losses, rtol=1e-4)
    assert ref_losses[-1] < ref_losses[0]
    for name in T.TrackParams._fields:
        got, want = getattr(tp, name), np.asarray(getattr(ref_tp, name))
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * lr,
                                   err_msg=name)
    np.testing.assert_allclose(
        T._assemble(tp, cfg).numpy(),
        np.asarray(ref_track._assemble(ref_tp, cfg)), rtol=0, atol=2 * lr)


def test_sequential_solve_matches_reference(cfg, assets, sequence):
    frames, lmk, start = sequence
    frames, lmk = frames[:3], lmk[:3]
    cnn = start[:3] + 0.05 * np.random.default_rng(4).standard_normal(
        start[:3].shape).astype(np.float32)
    lr, steps = 5e-3, 5
    ref_coeffs, ref_losses = ref_track.make_sequential_fn(cfg, steps, lr)(
        jnp.asarray(cnn), ref_device_bfm(assets), jnp.asarray(frames),
        jnp.asarray(lmk))
    coeffs, losses = T.make_sequential_fn(cfg, steps, lr)(
        cnn, device_bfm(assets, "cpu"), frames, lmk)
    assert losses.shape == (3, steps)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses),
                               rtol=1e-4)
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(ref_coeffs),
                               rtol=0, atol=2 * lr)
    # frame 0 starts from the CNN alone, the others from the blend
    assert not np.array_equal(coeffs.numpy()[0], cnn[0])


def test_smooth_assemble_decompose_equal_reference(cfg):
    coeff = np.random.default_rng(6).standard_normal(
        (5, cfg.n_coeff)).astype(np.float32)
    np.testing.assert_array_equal(T.smooth_coeffs(coeff, cfg),
                                  ref_track.smooth_coeffs(coeff, cfg))
    tp = T._decompose(torch.from_numpy(coeff), cfg)
    ref_tp = ref_track._decompose(jnp.asarray(coeff), cfg)
    for name in T.TrackParams._fields:
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(ref_tp, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    # assembled from the same leaves, the matrices are equal
    same = T.TrackParams(*(torch.tensor(np.asarray(x)) for x in ref_tp))
    np.testing.assert_array_equal(T._assemble(same, cfg).numpy(),
                                  np.asarray(ref_track._assemble(ref_tp, cfg)))
    # the per-frame columns come back exactly
    s = cfg.coeff_split
    back = T._assemble(tp, cfg).numpy()
    np.testing.assert_array_equal(back[:, s[0]:s[1]], coeff[:, s[0]:s[1]])
    np.testing.assert_array_equal(back[:, s[2]:], coeff[:, s[2]:])


# --- the CLI and the video loader ---

def _args(*argv):
    return T.parse_args(["--tiny", "--device", "cpu", *argv])


def test_video_needs_landmarks_to_align(tmp_path, cfg, assets):
    """The reference's align errors: 68pt/5pt need the landmark file, and
    an unknown mode is refused."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (32, 32))
    for _ in range(2):
        vw.write(np.full((32, 32, 3), 128, np.uint8))
    vw.release()
    with pytest.raises(ValueError, match="needs --video-landmarks"):
        load_video(path, cfg, align="68pt", assets=assets)
    with pytest.raises(ValueError, match="unknown align mode"):
        load_video(path, cfg, align="3pt")
    frames, lm = load_video(path, cfg, align="none")
    assert frames.shape == (2, cfg.image_size, cfg.image_size, 3)
    assert np.isnan(lm).all()
    with pytest.raises(ValueError, match="--video-landmarks track"):
        T.run(_args("--video", path, "--align", "none"))


def test_track_cli_smoke():
    """tests/test_drivers_cli.py:41 on the port: the loss falls and the
    metrics are finite; the report has the reference's keys."""
    rep = T.run(_args("--frames", "4", "--refine-steps", "30"))
    assert rep["loss_last"] < rep["loss_first"]
    assert np.isfinite(rep["psnr_db"])
    assert set(rep) == {"frames", "devices", "refine_s", "loss_first",
                        "loss_last", "psnr_db", "landmark_rmse_px",
                        "vertex_mae", "id_err"}


def test_track_defaults_match_reference():
    """--lr defaults to 1e-2 in the CLI and make_refine_fn's lr to 5e-3,
    as in the reference."""
    assert T.parse_args([]).lr == 1e-2
    assert T.make_refine_fn.__defaults__[0] == 5e-3
    assert T.make_sequential_fn.__defaults__ == (5e-3, 0.5)
    assert T.parse_args([]).device == "cuda"
    assert isinstance(T.parse_args([]), argparse.Namespace)
