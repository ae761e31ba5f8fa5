"""The port's drivers on users' data (fit.py, infer.py) and its own
BN -> fused fold, on the CPU at tiny_config(),
against the JAX reference with the same weights and targets, plus the
reference's own driver cases on the port (tests/test_drivers_cli.py:22-38,
tests/test_fit_track_ckpt.py:40-71, tests/test_real_input_drivers.py:30-55).
The trainer's driver is held in tests/test_torch_checkpoint.py.

On the CPU the reference renders through rasterize_tiled (Pallas does not
run there) and the port through the plain versions of its kernels. Bars:
  - fold_bn_model EQUALS the reference's fuse_variables (the same numpy
    float32 arithmetic); the fused pipeline's coefficients within 1e-4 x
    max|c| of the BatchNorm pipeline's in eval mode;
  - fit, 5 Adam steps from the same coefficients and targets: each loss
    within 1e-4 relative of the reference's, the final loss parts too,
    and every coefficient within 2 x lr (Adam moves a coordinate whose
    gradient is ~0 by up to lr a step in either direction);
  - infer, float32 models with the same weights: coefficients within
    1e-4 x max|c|, landmarks within 2e-3 px, the .obj files line for line
    (faces equal, vertex fields within 1e-4), the depth dump within one
    8-bit level on >= 99.9% of pixels (the winner may differ at a tie).
"""

import argparse
import functools
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch
from PIL import Image

from facerecon_tpu import fit as ref_fit
from facerecon_tpu import infer as ref_infer
from facerecon_tpu.models import fused as ref_fused
from facerecon_tpu.models.resnet import build_model as ref_build_model
from facerecon_tpu.ops.geometry import device_bfm as ref_device_bfm
from facerecon_tpu.pipeline import make_pipeline as ref_make_pipeline

from facerecon_tpu_torch import fit as TF
from facerecon_tpu_torch import infer as TI
from facerecon_tpu_torch import jax_params
from facerecon_tpu_torch import track as TK
from facerecon_tpu_torch import train as TT
from facerecon_tpu_torch.checkpoint import CheckpointManager
from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu_torch.models.fused import build_fused_model, fold_bn_model
from facerecon_tpu_torch.models.resnet import build_model
from facerecon_tpu_torch.ops.geometry import device_bfm
from facerecon_tpu_torch.pipeline import (fuse_for_inference,
                                          make_train_pipeline)
from facerecon_tpu_torch.utils.obj_io import load_obj

torch.set_num_threads(2)


def _leaf(path, shape, rng):
    """A non-trivial value for one BN-model variable, by its flax name."""
    name = jtu.keystr(path[-1:])
    n = rng.standard_normal(shape)
    if "kernel" in name:
        v = n / np.sqrt(np.prod(shape[:-1]))          # LeCun-normal
    elif "scale" in name:
        v = 1.0 + 0.1 * n
    elif "var" in name:
        v = np.abs(1.0 + 0.1 * n) + 0.01
    else:
        v = 0.1 * n                                   # bias, mean
    return v.astype(np.float32)


def _port_bn_model(cfg, var):
    model = build_model(cfg, dtype=torch.float32)
    model.load_state_dict(jax_params.train_state_dict(var))
    return model.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def bn_variables(cfg):
    """Perturbed BN-model variables (weights and running statistics), flax
    layout, numpy, with a head that keeps the face in frame: its bias is
    one sample_coeffs draw and its kernel adds a per-image variation of
    std 0.02 on random images (eval mode)."""
    model = ref_build_model(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(0)
    var = jtu.tree_map_with_path(lambda p, s: _leaf(p, s.shape, rng),
                                 dict(shapes))
    x = rng.random((4, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        probe = _port_bn_model(cfg, var)(torch.from_numpy(x)).numpy()
    head = var["params"]["Dense_0"]
    head["kernel"] = head["kernel"] * np.float32(
        0.02 / (probe - head["bias"]).std())
    head["bias"] = sample_coeffs(rng, cfg, 1)[0]
    return var


# --- the port's own BN -> fused fold ---

def test_fold_bn_model_equals_reference_fold(cfg, bn_variables):
    got = fold_bn_model(_port_bn_model(cfg, bn_variables))
    want = jax_params.fused_state_dict(jtu.tree_map(
        np.asarray, ref_fused.fuse_variables(bn_variables, cfg)))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    fused = build_fused_model(cfg, dtype=torch.float32)
    assert list(fused.state_dict()) == list(got)


def test_fuse_for_inference_keeps_the_eval_forward(cfg, assets,
                                                   bn_variables):
    pipe = make_train_pipeline(cfg, assets, device="cpu",
                               dtype=torch.float32)
    pipe.model.load_state_dict(jax_params.train_state_dict(bn_variables))
    pipe.model.train()
    fused = fuse_for_inference(pipe)
    assert fused.bfm is pipe.bfm and fused.device == pipe.device
    assert not fused.model.training
    assert all(p.dtype == torch.float32 for p in fused.model.parameters())
    images = np.random.default_rng(2).random(
        (2, 64, 64, 3)).astype(np.float32)
    cv_bn, _, out_bn = pipe.reconstruct(images)
    assert pipe.model.training            # reconstruct restores the mode
    cv, _, out = fused.reconstruct(images)
    scale = float(cv_bn.abs().max())
    assert float((cv - cv_bn).abs().max()) <= 1e-4 * scale
    assert float((out.tri_id == out_bn.tri_id).float().mean()) >= 0.999
    # the bf16 BN model folds into a bf16 fused model
    bf = make_train_pipeline(cfg, assets, device="cpu")
    assert fuse_for_inference(bf).model.stem.weight.dtype == torch.bfloat16


# --- fit against the reference ---

@pytest.fixture(scope="module")
def fit_target(cfg, assets):
    """Two rendered targets with landmarks (numpy), and a start near them."""
    gt = sample_coeffs(np.random.default_rng(11), cfg, 2)
    target, lmk = (t.numpy() for t in render_batch(
        gt, device_bfm(assets, "cpu"), cfg))
    start = (gt + 0.05 * np.random.default_rng(1).standard_normal(
        gt.shape)).astype(np.float32)
    return target, lmk, start


@pytest.mark.parametrize("start", ["zero", "near"])
def test_fit_matches_reference(cfg, assets, fit_target, start):
    target, lmk, near = fit_target
    coeff0 = near if start == "near" else np.zeros_like(near)
    lr, steps = 5e-3, 5
    ref = ref_fit.make_fit_fn(cfg, steps, lr)(
        jnp.asarray(coeff0), ref_device_bfm(assets), jnp.asarray(target),
        jnp.asarray(lmk))
    got = TF.make_fit_fn(cfg, steps, lr)(
        coeff0, device_bfm(assets, "cpu"), target, lmk)
    ref_losses = np.asarray(ref.losses)
    assert got.losses.shape == (steps,)
    np.testing.assert_allclose(got.losses.numpy(), ref_losses, rtol=1e-4)
    assert ref_losses[-1] < ref_losses[0]
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(ref.coeffs),
                               rtol=0, atol=2 * lr)
    assert set(got.final_parts) == set(ref.final_parts)
    for k, v in ref.final_parts.items():
        assert float(got.final_parts[k]) == pytest.approx(float(v),
                                                          rel=1e-4), k
    # the start is copied, not trained in place
    assert not got.coeffs.requires_grad
    assert not np.array_equal(got.coeffs.numpy(), coeff0)


def _fit_args(**kw):
    base = dict(steps=60, batch=1, images=None, align="68pt", lr=2e-2,
                landmarks=True, ckpt=None, out=None, tiny=True, seed=0,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_fit_improves():
    """tests/test_drivers_cli.py:34 on the port."""
    rep = TF.run(_fit_args())
    assert rep["loss_last"] < rep["loss_first"]
    assert set(rep) == {"steps", "batch", "fit_s", "loss_first", "loss_last",
                        "monotone_95pct", "psnr_vs_target_db",
                        "landmark_rmse_px"}


def test_fit_net_init_reaches_loss_in_half_steps(tmp_path, cfg, assets):
    """tests/test_fit_track_ckpt.py:40 on the port: a checkpoint whose
    zero-kernel head predicts gt + noise warm-starts the fit, which then
    beats the zero start at 20 steps and comes within 10% of its loss at
    40."""
    bfm = device_bfm(assets, "cpu")
    gt = sample_coeffs(np.random.default_rng(11), cfg, 1)
    target, gt_lmk = render_batch(gt, bfm, cfg)
    noisy = gt[0] + 0.02 * np.random.default_rng(1).standard_normal(
        gt[0].shape).astype(np.float32)
    pipe = make_train_pipeline(cfg, assets, device="cpu")
    with torch.no_grad():
        pipe.model.head.bias.copy_(torch.from_numpy(noisy))
    ck = str(tmp_path / "ck")
    CheckpointManager(ck).save(0, {"model": pipe.model.state_dict(),
                                   "step": 0})
    coeff0_net = TF.net_initial_coeffs(cfg, assets, target, ck,
                                       device="cpu")
    np.testing.assert_allclose(coeff0_net.numpy()[0], noisy, atol=1e-5)

    zero0 = torch.zeros((1, cfg.n_coeff))
    full = TF.make_fit_fn(cfg, steps=40)(zero0, bfm, target, gt_lmk)
    half = TF.make_fit_fn(cfg, steps=20)
    zero_half = half(zero0, bfm, target, gt_lmk)
    net_half = half(coeff0_net, bfm, target, gt_lmk)
    loss_net = float(net_half.losses[-1])
    assert loss_net < float(zero_half.losses[-1])
    assert loss_net <= float(full.losses[-1]) * 1.10


def test_fit_from_disk_recovers(tmp_path, cfg, assets):
    """tests/test_real_input_drivers.py:30 on the port: fit from a PNG
    folder with landmark side-cars, and the meshes it writes."""
    bfm = device_bfm(assets, "cpu")
    gt = sample_coeffs(np.random.default_rng(21), cfg, 2)
    images, lmk = (t.numpy() for t in render_batch(gt, bfm, cfg))
    data_dir = tmp_path / "photos"
    os.makedirs(data_dir)
    for i in range(2):
        Image.fromarray((np.clip(images[i], 0, 1) * 255).astype(
            np.uint8)).save(data_dir / f"img_{i:03d}.png")
        np.savetxt(data_dir / f"img_{i:03d}.txt", lmk[i], fmt="%.4f")
    out_dir = str(tmp_path / "fit_out")
    rep = TF.run(_fit_args(steps=120, batch=None, images=str(data_dir),
                           out=out_dir))
    assert rep["batch"] == 2
    assert rep["loss_last"] < rep["loss_first"] * 0.5
    assert rep["landmark_rmse_px"] < 1.5
    assert rep["psnr_vs_target_db"] > 19.0
    for name in ("img_000", "img_001"):
        verts, colors, faces = load_obj(
            os.path.join(out_dir, f"{name}_fit.obj"))
        assert verts.shape[1] == 3 and faces.shape == assets.faces.shape
        assert colors.shape == verts.shape
    assert np.load(os.path.join(out_dir, "fitted_coeffs.npy")).shape == (
        2, cfg.n_coeff)
    assert np.load(os.path.join(out_dir, "loss_curve.npy")).shape == (120,)


# --- infer against the reference ---

def _infer_args(out, **kw):
    base = dict(images=None, synthetic=2, out=str(out), ckpt=None, bfm=None,
                tiny=True, seed=0, overlay=True, depth=True, fused=False,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_infer_writes_outputs(tmp_path):
    """tests/test_drivers_cli.py:22 on the port."""
    rep = TI.run(_infer_args(tmp_path / "o"))
    assert rep["n_images"] == 2
    for suffix in (".obj", "_render.png", "_landmarks.txt", "_coeffs.npy",
                   "_overlay.png", "_depth.png"):
        assert (tmp_path / "o" / f"synthetic_0{suffix}").exists(), suffix
    assert np.isfinite(rep["landmark_rmse_px"])


def test_infer_defaults_match_reference():
    """--out defaults to the reference's /tmp/facerecon_out
    (facerecon_tpu/infer.py), and --device to cuda."""
    args = TI.parse_args([])
    assert args.out == "/tmp/facerecon_out"
    assert args.device == "cuda"
    assert isinstance(args, argparse.Namespace)


def _obj_lines(path):
    with open(path) as fh:
        return [line.split() for line in fh]


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "fused"])
def test_infer_matches_reference(tmp_path, monkeypatch, cfg, assets,
                                 bn_variables, fused):
    """Both drivers in float32 on the same weights: the reference's through
    its restore hook, the port's from a checkpoint of the port's layout."""
    monkeypatch.setattr(ref_infer, "make_pipeline", functools.partial(
        ref_make_pipeline, dtype=jnp.float32))
    monkeypatch.setattr(ref_infer, "restore_variables",
                        lambda pipe, ckpt, seed=0: bn_variables)
    monkeypatch.setattr(ref_fused, "build_fused_model", functools.partial(
        ref_fused.build_fused_model, dtype=jnp.float32))
    monkeypatch.setattr(TI, "make_train_pipeline", functools.partial(
        make_train_pipeline, dtype=torch.float32))
    ck = str(tmp_path / "ck")
    CheckpointManager(ck).save(3, {
        "model": jax_params.train_state_dict(bn_variables), "step": 3})
    ref_rep = ref_infer.run(_infer_args(tmp_path / "ref", fused=fused,
                                        platform=None))
    rep = TI.run(_infer_args(tmp_path / "port", ckpt=ck, fused=fused))
    assert set(rep) == set(ref_rep)
    assert rep["landmark_rmse_px"] == pytest.approx(
        ref_rep["landmark_rmse_px"], abs=2e-3)
    names = sorted(os.path.basename(p)
                   for p in glob.glob(str(tmp_path / "ref" / "*")))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 12
    for i in range(2):
        def both(suffix, load):
            return (load(str(tmp_path / d / f"synthetic_{i}{suffix}"))
                    for d in ("port", "ref"))
        c, c_ref = both("_coeffs.npy", np.load)
        assert float(np.abs(c - c_ref).max()) <= 1e-4 * float(
            np.abs(c_ref).max())
        lm, lm_ref = both("_landmarks.txt", np.loadtxt)
        np.testing.assert_allclose(lm, lm_ref, rtol=0, atol=2e-3)
        obj, obj_ref = both(".obj", _obj_lines)
        assert len(obj) == len(obj_ref)
        assert [x[0] for x in obj] == [x[0] for x in obj_ref]
        faces = [x for x in obj if x[0] == "f"]
        assert faces == [x for x in obj_ref if x[0] == "f"]
        assert len(faces) == assets.n_faces
        v = np.array([x[1:] for x in obj if x[0] == "v"], np.float64)
        v_ref = np.array([x[1:] for x in obj_ref if x[0] == "v"], np.float64)
        np.testing.assert_allclose(v, v_ref, rtol=0, atol=1e-4)
        d, d_ref = both("_depth.png",
                        lambda p: np.asarray(Image.open(p), np.int16))
        assert (d > 0).mean() > 0.1
        assert (np.abs(d - d_ref) <= 1).mean() >= 0.999


@pytest.mark.parametrize("driver", ["train", "fit", "infer", "track"])
def test_drivers_need_a_card_unless_asked_for_cpu(tmp_path, driver):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = {"train": TT.main, "fit": TF.main, "infer": TI.main,
            "track": TK.main}[driver]
    argv = {"infer": ["--tiny", "--synthetic", "1", "--out",
                      str(tmp_path / "o")],
            "track": ["--tiny", "--frames", "2", "--refine-steps", "1"]
            }.get(driver, ["--tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
