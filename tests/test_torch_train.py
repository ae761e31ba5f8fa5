"""The port's training pieces against the JAX reference at tiny_config():
the BatchNorm ResNet (models/resnet.py, carried over with
jax_params.train_state_dict), the learning-rate schedule, the losses, and
the trainer's own loop and CLI on the CPU.

Bars:
  - BatchNorm alone: output, input gradient and running statistics
    within 4e-6 of flax's (a few float32 ulps at values up to ~4: the
    two compute the variance by different formulas);
  - the BN model in train mode (float32): output within 1e-4 x max and
    the updated running statistics within 1e-5 of flax's
    apply(..., mutable=["batch_stats"]). Measured on a (2, 1, 1, 1)-block
    model: the two frameworks' CPU convolutions sum in different orders,
    and that drift grows with depth (depth 18's last stage, normalised
    over 8 values a channel, reaches 1.7e-5 in its running variance);
  - the schedule equal to optax's to float32 rounding at steps 0, 1, the
    end of warmup and beyond;
  - Adam on the schedule, fed the same gradients as optax.adam: the
    parameters within 1e-3 x lr + 2 float32 ulps after every update;
  - each loss term within 1e-5 relative of the reference's on the same
    inputs.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import optax
import pytest
import torch
from flax import linen as nn

from facerecon_tpu.models.resnet import ResNetRegressor
from facerecon_tpu.ops import geometry as G
from facerecon_tpu.ops import losses as L
from facerecon_tpu.ops.render import RenderOut
from facerecon_tpu.utils.coeffs import split_coeff

from facerecon_tpu_torch import jax_params
from facerecon_tpu_torch import train as TT
from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu_torch.models import resnet as TRn
from facerecon_tpu_torch.ops import geometry as TG
from facerecon_tpu_torch.ops import losses as TL
from facerecon_tpu_torch.ops import render as TRe
from facerecon_tpu_torch.pipeline import make_train_pipeline, regress_coeffs
from facerecon_tpu_torch.utils.coeffs import split_coeff as t_split_coeff

torch.set_num_threads(2)


def _nchw(a):
    return torch.tensor(a).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (3, 16, 16, 8)])
def test_batchnorm_matches_flax(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    gy = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    var = {"params": {"scale": scale, "bias": bias},
           "batch_stats": {"mean": np.zeros(shape[-1], np.float32),
                           "var": np.ones(shape[-1], np.float32)}}

    def f(xx):
        y, upd = bn.apply(var, xx, mutable=["batch_stats"])
        return jnp.sum(y * gy), (y, upd)

    (_, (y, upd)), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    m = TRn.BatchNorm(shape[-1]).train()
    with torch.no_grad():
        m.weight.copy_(torch.tensor(scale))
        m.bias.copy_(torch.tensor(bias))
    xt = _nchw(x).requires_grad_(True)
    yt = m(xt)
    (gt,) = torch.autograd.grad(torch.sum(yt * _nchw(gy)), xt)
    np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), rtol=0, atol=4e-6)
    np.testing.assert_allclose(gt.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), rtol=0, atol=4e-6)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(m, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=0, atol=4e-6)


def test_bn_model_train_mode_matches_flax(cfg):
    stages = (2, 1, 1, 1)
    model = ResNetRegressor(n_coeff=cfg.n_coeff, stage_sizes=stages,
                            dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = jtu.keystr(path[-1:])
        n = rng.standard_normal(s.shape)
        if "kernel" in name:
            v = n / np.sqrt(np.prod(s.shape[:-1]))
        elif "scale" in name:
            v = 1.0 + 0.1 * n
        elif "var" in name:
            v = np.abs(1.0 + 0.1 * n) + 0.01
        else:
            v = 0.1 * n
        return v.astype(np.float32)

    var = jtu.tree_map_with_path(leaf, dict(shapes))
    x = rng.random((3, 64, 64, 3)).astype(np.float32)
    y, upd = model.apply(var, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tm = TRn.ResNetRegressor(cfg.n_coeff, stages, dtype=torch.float32)
    tm.load_state_dict(jax_params.train_state_dict(var))
    tm = tm.to(memory_format=torch.channels_last).train()
    with torch.no_grad():
        ty = tm(torch.tensor(x)).numpy()
    y = np.asarray(y)
    assert float(np.abs(ty - y).max()) <= 1e-4 * float(np.abs(y).max())
    want = jax_params.train_state_dict(
        {"params": var["params"],
         "batch_stats": jtu.tree_map(np.asarray, upd["batch_stats"])})
    n = 0
    for name, buf in tm.named_buffers():
        assert float((buf - want[name]).abs().max()) <= 1e-5, name
        n += 1
    assert n == 2 * (1 + 3 * sum(stages) + len(stages))
    # eval mode reads the running statistics
    tm.eval()
    y_eval = np.asarray(model.apply(var, jnp.asarray(x), train=False))
    tm.load_state_dict(jax_params.train_state_dict(var))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    assert float(np.abs(got - y_eval).max()) <= 1e-4 * float(
        np.abs(y_eval).max())


def test_fresh_model_predicts_the_mean_face(cfg):
    tm = TRn.build_model(cfg, depth=18, dtype=torch.float32)
    tm.reset_parameters_(torch.Generator().manual_seed(0))
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    assert torch.equal(tm(x), torch.zeros((2, cfg.n_coeff)))
    assert all(not b.bn2.weight.detach().any() for b in tm.blocks)
    w = tm.stem.weight.detach()
    assert float(w.abs().max()) <= 2 * (1 / 147) ** 0.5 / 0.8796 + 1e-6
    assert 0.5 < float(w.std()) * 147 ** 0.5 < 1.5


@pytest.mark.parametrize("total", [3, 50, 100_000])
def test_schedule_matches_optax(cfg, total):
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate,
        warmup_steps=min(1000, max(1, total // 20)),
        decay_steps=max(2, total))
    got = TT.lr_schedule(cfg, total)
    warm = min(1000, max(1, total // 20))
    for k in sorted({0, 1, warm - 1, warm, warm + 1, total // 2, total,
                     total + 5}):
        assert abs(got(k) - float(ref(k))) <= 1e-6 * cfg.learning_rate, k
    assert got(0) == 0.0
    # the optimizer's first update runs at sched(0), as optax's does
    p = torch.nn.Parameter(torch.ones(3))
    opt, sched = TT.make_optimizer(cfg, [p], total)
    rates = []
    for _ in range(3):
        rates.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    assert rates == pytest.approx([got(0), got(1), got(2)], rel=1e-12,
                                  abs=1e-20)


@pytest.mark.parametrize("total", [40, 100_000])
def test_adam_matches_optax(cfg, total):
    """The port's Adam + LambdaLR against the reference's optax.adam on
    the schedule, fed the same gradients: after every update the
    parameters within 1e-3 x lr + 2 float32 ulps of optax's. Gradients
    of size 1e-9..1 probe where eps enters, and a warmup of 2 (total 40)
    probes the count the schedule is read at."""
    from facerecon_tpu.train import make_optimizer as ref_optimizer
    rng = np.random.default_rng(6)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 7), (11,))]
    ref = ref_optimizer(cfg, total)
    rp = [jnp.asarray(p) for p in p0]
    rs = ref.init(rp)
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    opt, sched = TT.make_optimizer(cfg, tp, total)
    lr = cfg.learning_rate
    for k in range(6):
        grads = [(rng.standard_normal(p.shape)
                  * 10.0 ** rng.integers(-9, 1, p.shape)).astype(np.float32)
                 for p in p0]
        upd, rs = ref.update([jnp.asarray(g) for g in grads], rs, rp)
        rp = optax.apply_updates(rp, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.tensor(g)
        opt.step()
        sched.step()
        for p, r in zip(tp, rp):
            r = np.asarray(r)
            bar = 1e-3 * lr + 2 * np.spacing(np.abs(r))
            assert np.all(np.abs(p.detach().numpy() - r) <= bar), k
        moved = max(float(np.abs(np.asarray(r) - p).max())
                    for r, p in zip(rp, p0))
        assert (moved == 0.0) == (k == 0), k


def test_losses_match_reference(cfg, assets):
    rng = np.random.default_rng(4)
    b, s = 2, cfg.image_size
    coeff = sample_coeffs(rng, cfg, b)
    bfm = G.device_bfm(assets)
    tbfm = TG.device_bfm(assets, "cpu")
    c = split_coeff(jnp.asarray(coeff), cfg)
    tc = t_split_coeff(torch.tensor(coeff), cfg)
    image = rng.random((b, s, s, 3)).astype(np.float32)
    target = rng.random((b, s, s, 3)).astype(np.float32)
    tri_id = rng.integers(-1, assets.n_faces, (b, s, s)).astype(np.int32)
    bary = rng.random((b, s, s, 3)).astype(np.float32)
    mask = (tri_id >= 0).astype(np.float32)
    skin = rng.random((b, s, s)).astype(np.float32)
    lmk = (rng.random((b, 68, 2)) * s).astype(np.float32)
    gt_lmk = (rng.random((b, 68, 2)) * s).astype(np.float32)
    tex = rng.random((b, assets.n_vertices, 3)).astype(np.float32)

    class Geo:          # the loss reads only these two fields
        pass

    geo, tgeo = Geo(), Geo()
    geo.landmarks2d, geo.texture = jnp.asarray(lmk), jnp.asarray(tex)
    tgeo.landmarks2d, tgeo.texture = torch.tensor(lmk), torch.tensor(tex)

    def outs(with_skin):
        ref = RenderOut(image=jnp.asarray(image), mask=jnp.asarray(mask),
                        tri_id=jnp.asarray(tri_id), bary=jnp.asarray(bary),
                        radiance=None, geometry=geo,
                        skin=jnp.asarray(skin) if with_skin else None)
        got = TRe.RenderOut(image=torch.tensor(image),
                            mask=torch.tensor(mask),
                            tri_id=torch.tensor(tri_id),
                            bary=torch.tensor(bary), radiance=None,
                            geometry=tgeo,
                            skin=torch.tensor(skin) if with_skin else None)
        return ref, got

    def close(a, b):
        a, b = float(a), float(b)
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)

    ref, got = outs(False)
    sk_ref = np.asarray(L.skin_mask_image(ref, bfm))
    sk_got = TL.skin_mask_image(got, tbfm).numpy()
    np.testing.assert_allclose(sk_got, sk_ref, rtol=1e-6, atol=1e-7)
    close(TL.photometric_loss(torch.tensor(image), torch.tensor(target),
                              torch.tensor(mask)),
          L.photometric_loss(jnp.asarray(image), jnp.asarray(target),
                             jnp.asarray(mask)))
    close(TL.landmark_loss(torch.tensor(lmk), torch.tensor(gt_lmk), cfg),
          L.landmark_loss(jnp.asarray(lmk), jnp.asarray(gt_lmk), cfg))
    np.testing.assert_array_equal(TL.landmark_weights(cfg).numpy(),
                                  np.asarray(L.landmark_weights(cfg)))
    close(TL.regularization_loss(tc, tbfm, cfg),
          L.regularization_loss(c, bfm, cfg))
    close(TL.gamma_loss(tc.gamma), L.gamma_loss(c.gamma))
    close(TL.texture_variance_loss(torch.tensor(tex), tbfm),
          L.texture_variance_loss(jnp.asarray(tex), bfm))
    cfg_tv = cfg.__class__(**{**cfg.__dict__, "w_tex_var": 0.5})
    for with_skin in (False, True):
        ref, got = outs(with_skin)
        for lm in (None, gt_lmk):
            _, p_ref = L.total_loss(ref, c, jnp.asarray(target),
                                    None if lm is None else jnp.asarray(lm),
                                    bfm, cfg_tv)
            _, p_got = TL.total_loss(got, tc, torch.tensor(target),
                                     None if lm is None
                                     else torch.tensor(lm), tbfm, cfg_tv)
            assert set(p_got) == set(p_ref)
            for k in p_ref:
                close(p_got[k], p_ref[k])


def test_train_step_decreases_loss(cfg, assets):
    """Twin of tests/test_pipeline_and_drivers.py:44 on the port: 20
    steps on one rendered batch, the loss falls and the count is 20."""
    pipe = make_train_pipeline(cfg, assets, device="cpu",
                               dtype=torch.float32, depth=18)
    state = TT.init_state(pipe, total_steps=50)
    step = TT.make_train_step(pipe)
    gt = sample_coeffs(np.random.default_rng(0), cfg, cfg.batch_size)
    images, lmk = render_batch(gt, pipe.bfm, cfg)
    first = None
    for i in range(20):
        parts = step(state, images, lmk)
        if i == 0:
            first = float(parts["total"])
    assert float(parts["total"]) < first
    assert state.step == 20
    assert all(bool(torch.isfinite(v)) for v in parts.values())
    # eval mode regresses from the updated running statistics
    with torch.no_grad():
        a = regress_coeffs(pipe, images, train=False)
        b = pipe.model(images)
    assert not pipe.model.training and torch.equal(a, b)


def test_train_cli_runs_on_cpu(capsys):
    report = TT.main(["--tiny", "--device", "cpu", "--steps", "5",
                      "--batch", "2", "--log-every", "1", "--data-pool",
                      "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines[:-1]] == [1, 2, 3, 4, 5]
    # the rate leaves out the first min(3, n_iters - 1) iterations
    assert all(np.isnan(x["faces_per_sec"]) for x in lines[:4])
    assert lines[4]["faces_per_sec"] > 0
    assert {"photo", "reg", "gamma", "landmark", "total"} <= set(lines[4])
    assert lines[-1] == report and report["steps"] == 5
    assert report["first_loss"] == pytest.approx(lines[0]["total"],
                                                 abs=1e-5)
