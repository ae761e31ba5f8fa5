"""The port's converters (convert_weights.py, convert_assets.py) on the
CPU against the reference's on the same files:
  - a torchvision-layout ResNet-50 state dict, made by renaming the
    reference model's carried weights (jax_params.train_state_dict, then
    the torchvision names), imports into the port EQUAL to
    train_state_dict of the reference's import_torch_resnet on the same
    file, with the same report (the skipped shapes in each package's own
    layout);
  - the shape-mismatch report (tests/test_convert_weights.py:86-96);
  - import_flat and flatten_params give the reference's matches on its
    flax addresses (tests/test_aux.py:66), and a TF-1.x checkpoint lands
    on the same weights in both packages (tests/test_convert_weights.py:
    98-171, each under importorskip("tensorflow") as there);
  - the converter's CLI checkpoint, read back by `infer --ckpt`;
  - convert_assets on tests/test_convert_assets.py's `.mat` files: the
    port's `.npz` equals the reference's array for array, and the
    truncation and bad-index errors match.
"""

import numpy as np
import jax
import pytest
import scipy.io as sio
import torch

from facerecon_tpu import convert_assets as ref_ca
from facerecon_tpu import convert_weights as ref_cw
from facerecon_tpu.pipeline import init_params, make_pipeline

from facerecon_tpu_torch import convert_assets as ca
from facerecon_tpu_torch import convert_weights as cw
from facerecon_tpu_torch import infer, jax_params
from facerecon_tpu_torch.checkpoint import CheckpointManager
from facerecon_tpu_torch.config import tiny_config
from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu_torch.models.resnet import build_model
from facerecon_tpu_torch.ops.geometry import device_bfm
from facerecon_tpu_torch.utils.bfm import synthetic_bfm

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref_variables(cfg, assets):
    """The reference's tiny ResNet-50 variables, each leaf perturbed
    (seeded) so no two layers hold the same values."""
    variables = init_params(make_pipeline(cfg, assets),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda x: np.asarray(x, np.float32) + rng.uniform(
        0.01, 0.1, x.shape).astype(np.float32), jax.device_get(variables))


def _port_model(cfg, variables=None):
    model = build_model(cfg).reset_parameters_(
        torch.Generator().manual_seed(0))
    if variables is not None:
        model.load_state_dict(jax_params.train_state_dict(variables))
    return model


def _equal_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# --- convert_weights: the torchvision path ---

def test_torch_resnet_import_equals_reference(tmp_path, cfg, assets,
                                              ref_variables):
    # the reference's weights under torchvision's names (OIHW), with
    # torchvision's 1000-class head and its BN step counter
    port_names = jax_params.train_state_dict(ref_variables)
    to_tv = {v: k for k, v in cw._resnet_key_map(50).items()}
    sd = {to_tv[k]: v for k, v in port_names.items()}
    sd["fc.weight"] = torch.ones((1000, sd["fc.weight"].shape[1]))
    sd["fc.bias"] = torch.ones(1000)
    sd["bn1.num_batches_tracked"] = torch.tensor(7)
    path = str(tmp_path / "resnet50.pt")
    torch.save(sd, path)

    template = init_params(make_pipeline(cfg, assets), jax.random.PRNGKey(0))
    ref_vars, ref_report = ref_cw.import_torch_resnet(
        template, ref_cw.from_torch_state_dict(path))
    got, report = cw.import_torch_resnet(_port_model(cfg),
                                         cw.from_torch_state_dict(path))
    _equal_state(got, jax_params.train_state_dict(
        jax.device_get(ref_vars)))
    # every carried weight arrived; the head kept its zero init
    for k, v in port_names.items():
        if not k.startswith("head."):
            assert torch.equal(got[k], v), k
    assert not got["head.weight"].any()

    for key in ("imported", "unknown_keys", "missing_expected"):
        assert report[key] == ref_report[key], key
    assert report["imported"] == len(sd) - 3
    assert report["unknown_keys"] == ["bn1.num_batches_tracked"]
    assert [s[0] for s in report["shape_skipped"]] == [
        s[0] for s in ref_report["shape_skipped"]] == ["fc.weight", "fc.bias"]
    # the skipped shapes, in torch's layout here and flax's there
    for (_, a, b), (_, ra, rb) in zip(report["shape_skipped"],
                                      ref_report["shape_skipped"]):
        assert (a, b) == (ra[::-1], rb[::-1])


def test_import_reports_shape_mismatch(cfg, assets):
    """tests/test_convert_weights.py:86 on the port."""
    bad = {"conv1.weight": np.zeros((3, 3, 3, 64), np.float32),
           "not.a.resnet.key": np.zeros((1,), np.float32)}
    _, report = cw.import_torch_resnet(_port_model(cfg), bad)
    template = init_params(make_pipeline(cfg, assets), jax.random.PRNGKey(0))
    _, ref_report = ref_cw.import_torch_resnet(template, bad)
    assert report["imported"] == ref_report["imported"] == 0
    assert report["shape_skipped"] == [("conv1.weight", (3, 3, 3, 64),
                                        (64, 3, 7, 7))]
    assert ref_report["shape_skipped"][0][0] == "conv1.weight"
    assert report["unknown_keys"] == ref_report["unknown_keys"] == [
        "not.a.resnet.key"]
    assert report["missing_expected"] == ref_report["missing_expected"]


# --- convert_weights: flax addresses and TF checkpoints ---

def test_flatten_params_equals_reference(cfg, ref_variables):
    flat = cw.flatten_params(_port_model(cfg, ref_variables))
    want = ref_cw.flatten_params(ref_variables["params"])
    assert list(flat) == list(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def test_import_flat_maps_by_name_and_shape(cfg, ref_variables):
    """tests/test_aux.py:66 on the port: every weight, perturbed and
    imported back by name and shape, finds a match, and lands where the
    reference's rule puts it (a suffix match takes the first same-shaped
    candidate, as there: a block's BatchNorm_0/scale may take the stem's);
    the running statistics stay as they are."""
    model = _port_model(cfg, ref_variables)
    flat = {k: v + 1.0 for k, v in cw.flatten_params(model).items()}
    got, report = cw.import_flat(model, flat)
    ref_params, ref_report = ref_cw.import_flat(ref_variables["params"],
                                                flat)
    assert report == ref_report
    assert report["unmatched"] == 0
    _equal_state(got, jax_params.train_state_dict(
        {"params": jax.device_get(ref_params),
         "batch_stats": ref_variables["batch_stats"]}))
    torch.testing.assert_close(got["head.weight"],
                               model.head.weight.detach() + 1.0)


def _tf_checkpoint(tf, path, variables):
    tf1 = tf.compat.v1
    with tf1.Graph().as_default():
        for name, value in variables.items():
            tf1.get_variable(name, initializer=value)
        saver = tf1.train.Saver()
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, path)


def test_tf_checkpoint_lands_on_the_reference_weights(tmp_path, cfg,
                                                      ref_variables):
    """A TF-1.x checkpoint (plain variable names via tf.compat.v1
    Saver) read by from_tf_checkpoint and mapped by import_flat gives
    the weights the reference's import_flat gives, conv kernels
    included."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(3)
    params = ref_variables["params"]
    head = params["Dense_0"]
    conv = params["BottleneckBlock_3"]["Conv_1"]["kernel"]
    tfvars = {
        "net/Dense_0/kernel": rng.standard_normal(
            head["kernel"].shape).astype(np.float32),
        "net/Dense_0/bias": rng.standard_normal(
            head["bias"].shape).astype(np.float32),
        "net/BottleneckBlock_3/Conv_1/kernel": rng.standard_normal(
            conv.shape).astype(np.float32),
        "net/unrelated": rng.standard_normal((7,)).astype(np.float32)}
    ckpt = str(tmp_path / "tf1" / "model.ckpt")
    _tf_checkpoint(tf, ckpt, tfvars)

    flat = cw.from_tf_checkpoint(ckpt)
    np.testing.assert_array_equal(flat["net/Dense_0/kernel"],
                                  tfvars["net/Dense_0/kernel"])
    got, report = cw.import_flat(_port_model(cfg, ref_variables), flat)
    ref_params, ref_report = ref_cw.import_flat(params,
                                                ref_cw.from_tf_checkpoint(
                                                    ckpt))
    assert report == ref_report
    assert report["matched"] == 3
    _equal_state(got, jax_params.train_state_dict(
        {"params": jax.device_get(ref_params),
         "batch_stats": ref_variables["batch_stats"]}))
    np.testing.assert_array_equal(got["head.weight"].numpy(),
                                  tfvars["net/Dense_0/kernel"].T)


def test_tf_cli_roundtrip(tmp_path):
    """tests/test_convert_weights.py:141 on the port: --tf writes a port
    checkpoint holding the TF head kernel."""
    tf = pytest.importorskip("tensorflow")
    cfg = tiny_config()
    shape = tuple(build_model(cfg).head.weight.shape[::-1])   # flax (in, out)
    marker = np.full(shape, 0.125, np.float32)
    ckpt = str(tmp_path / "tfsrc" / "model.ckpt")
    _tf_checkpoint(tf, ckpt, {"Dense_0/kernel": marker})
    out_dir = str(tmp_path / "converted")
    cw.main(["--tf", ckpt, "--out", out_dir, "--tiny"])
    state = CheckpointManager(out_dir).restore()
    assert state["step"] == 0
    np.testing.assert_array_equal(state["model"]["head.weight"].numpy(),
                                  marker.T)


def test_torch_cli_checkpoint_read_by_infer(tmp_path, capsys):
    """--torch writes a port checkpoint; `infer --ckpt --device cpu`
    restores it and regresses what the imported model regresses."""
    cfg = tiny_config()
    src = build_model(cfg).reset_parameters_(
        torch.Generator().manual_seed(5))
    with torch.no_grad():
        src.head.weight.normal_(0.0, 0.01, generator=torch.Generator()
                                .manual_seed(6))
    to_tv = {v: k for k, v in cw._resnet_key_map(50).items()}
    path = str(tmp_path / "sd.pt")
    torch.save({to_tv[k]: v for k, v in src.state_dict().items()}, path)
    out_dir = str(tmp_path / "converted")
    cw.main(["--torch", path, "--out", out_dir, "--tiny"])
    assert "'imported': " in capsys.readouterr().out

    infer.run(infer.parse_args(["--tiny", "--device", "cpu", "--synthetic",
                                "1", "--ckpt", out_dir, "--out",
                                str(tmp_path / "o")]))
    images, _ = render_batch(sample_coeffs(np.random.default_rng(0), cfg, 1),
                             device_bfm(synthetic_bfm(cfg, 0), "cpu"), cfg)
    with torch.no_grad():
        want = src.eval()(images).numpy()[0]
    got = np.load(tmp_path / "o" / "synthetic_0_coeffs.npy")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(want).max() > 0


# --- convert_assets ---

@pytest.fixture(scope="module")
def src():
    return synthetic_bfm(tiny_config(), seed=3)


def _both(tmp_path, mat, **kw):
    """The reference's and the port's .npz of one .mat, as dicts."""
    out = []
    for name, mod in (("ref", ref_ca), ("port", ca)):
        path = tmp_path / f"{name}.npz"
        mod.convert(str(mat), str(path), verbose=False, **kw)
        with np.load(path) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _assert_same_npz(ref, got):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_deep3d_mat_converts_as_reference(tmp_path, src):
    mat = tmp_path / "bfm_front.mat"
    sio.savemat(mat, {
        "meanshape": src.mean_shape[None, :],
        "idBase": src.id_basis,
        "exBase": src.exp_basis,
        "meantex": src.mean_tex[None, :],
        "texBase": src.tex_basis,
        "tri": src.faces.astype(np.float64) + 1,
        "keypoints": src.landmark_index[None, :].astype(np.float64) + 1,
        "skinmask": src.skin_mask[None, :],
    })
    ref, got = _both(tmp_path, mat)
    _assert_same_npz(ref, got)
    np.testing.assert_array_equal(got["faces"], src.faces)


def _bfm09(src):
    return {"shapeMU": src.mean_shape[:, None],
            "shapePC": src.id_basis,
            "shapeEV": src.sigma_id[:, None],
            "texMU": src.mean_tex[:, None],
            "texPC": src.tex_basis,
            "texEV": src.sigma_tex[:, None],
            "tl": src.faces.astype(np.float64) + 1}


def test_bfm09_mat_with_exp_side_file_converts_as_reference(tmp_path, src,
                                                            capsys):
    mat, expm = tmp_path / "model.mat", tmp_path / "exp.mat"
    sio.savemat(mat, _bfm09(src))
    sio.savemat(expm, {"expPC": src.exp_basis,
                       "expEV": src.sigma_exp[:, None]})
    ref, got = _both(tmp_path, mat, n_id=src.id_basis.shape[1],
                     n_exp=src.exp_basis.shape[1],
                     n_tex=src.tex_basis.shape[1], exp_mat=str(expm))
    _assert_same_npz(ref, got)
    assert np.all(got["skin_mask"] == 1.0)
    # the loud defaults, as the reference prints them
    ca.main([str(mat), str(tmp_path / "cli.npz"), "--exp-mat", str(expm)])
    assert "WARNING: defaulted skin_mask" in capsys.readouterr().out


def test_truncation_and_bad_indices_as_reference(tmp_path, src):
    mat = tmp_path / "model.mat"
    sio.savemat(mat, _bfm09(src))
    ref, got = _both(tmp_path, mat, n_id=7, n_exp=5, n_tex=6)
    _assert_same_npz(ref, got)
    assert got["id_basis"].shape[1] == 7 and got["tex_basis"].shape[1] == 6
    assert got["exp_basis"].shape[1] == 5 and not got["exp_basis"].any()

    bad = dict(sio.loadmat(str(mat)))
    bad["tl"] = bad["tl"] + 10_000
    sio.savemat(str(mat), bad)
    for mod in (ref_ca, ca):
        with pytest.raises(ValueError, match="out of range"):
            mod.convert(str(mat), str(tmp_path / "b.npz"), verbose=False)
    sio.savemat(str(mat), {"something_else": np.zeros(3)})
    for mod in (ref_ca, ca):
        with pytest.raises(ValueError, match="unrecognized"):
            mod.convert(str(mat), str(tmp_path / "c.npz"), verbose=False)
