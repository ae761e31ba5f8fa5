"""The whole training slice: one step of the port's trainer (float32,
depth 18, CPU) against facerecon_tpu.train.make_train_step
(dtype=float32) from the same carried weights, batch and landmarks.

On the CPU the reference renders through rasterize_tiled + shade_packed
and gathers the skin mask per pixel (rasterize_pallas.is_available() is
false off the TPU), while the port runs its select path (the plain
versions of K2 and K3). tri_id must agree on >= 99.9% of pixels. Bars:
every loss part within 1e-4 relative; every parameter gradient within
1e-3 of its tensor's max |g| (the two frameworks' CPU convolutions sum in
different orders, and the render's barycentrics come from different
formulas of the same values); the updated BN running statistics within
1e-5. The weights are the reference's initial ones with a head that is
not zero (see _variables).

The reference's gradient is read from its Adam state: the first update
leaves mu = (1 - b1) * g. Both first updates use lr = sched(0) = 0, so
neither moves a parameter. A second step on the same batch then updates
at lr = sched(1) > 0: each parameter's move within 1e-3 x lr + 2 float32
ulps of the reference's where |g| > 2e-3 of its tensor's max (there the
gradient bar fixes the sign of Adam's step), and within 2 x lr + 2 ulps
elsewhere.
"""

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import optax
import pytest
import torch

from facerecon_tpu.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu.ops.render import render_coeffs
from facerecon_tpu.pipeline import make_pipeline
from facerecon_tpu.train import TrainState, make_optimizer, make_train_step
from facerecon_tpu.utils.coeffs import split_coeff

from facerecon_tpu_torch import jax_params
from facerecon_tpu_torch import train as TT
from facerecon_tpu_torch.ops.render import render_coeffs as t_render_coeffs
from facerecon_tpu_torch.pipeline import make_train_pipeline
from facerecon_tpu_torch.utils.coeffs import split_coeff as t_split_coeff

torch.set_num_threads(2)

BATCH = 2


def _variables(pipe, images):
    """The reference's initial variables (flax init, as init_state makes
    them: LeCun-normal kernels, unit BN scales with each block's last BN
    at zero, unit running statistics) with a head that is not zero, so
    the gradient reaches the backbone: its bias is one sample_coeffs draw
    and its kernel adds a per-image variation of std 0.02, so the face
    stays in frame. (From randomly perturbed BN scales the backbone's
    float32 gradient is not a smooth function of the rounding: a ReLU
    whose input lies within rounding of zero flips, and torch in float32
    and float64 then differ by several percent of a tensor's max.)"""
    model = pipe.model
    var = jtu.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.asarray(images), train=False))
    rng = np.random.default_rng(0)
    head = var["params"]["Dense_0"]
    head["kernel"] = rng.standard_normal(head["kernel"].shape).astype(
        np.float32)
    probe = np.asarray(model.apply(var, jnp.asarray(images), train=True,
                                   mutable=["batch_stats"])[0])
    head["kernel"] *= np.float32(0.02 / probe.std())
    head["bias"] = sample_coeffs(rng, pipe.cfg, 1)[0]
    return var


@pytest.fixture(scope="module")
def reference_step(cfg, assets):
    pipe = make_pipeline(cfg, assets, depth=18, dtype=jnp.float32)
    gt = sample_coeffs(np.random.default_rng(3), cfg, BATCH)
    images, lmk = render_batch(gt, pipe.bfm, cfg)
    var = _variables(pipe, images)
    opt = make_optimizer(cfg, total_steps=50)
    params = jtu.tree_map(jnp.asarray, var["params"])
    state = TrainState(
        variables={"params": params,
                   "batch_stats": jtu.tree_map(jnp.asarray,
                                               var["batch_stats"])},
        opt_state=opt.init(params), step=jnp.zeros((), jnp.int32))
    train_step = make_train_step(pipe, opt)
    new_state, parts = train_step(state, pipe.bfm, jnp.asarray(images),
                                  jnp.asarray(lmk))
    adam = new_state.opt_state[0]
    assert isinstance(adam, optax.ScaleByAdamState)
    grads = jtu.tree_map(lambda m: np.asarray(m) / np.float32(0.1),
                         adam.mu)
    stats = jtu.tree_map(np.asarray, new_state.variables["batch_stats"])
    second, _ = train_step(new_state, pipe.bfm, jnp.asarray(images),
                           jnp.asarray(lmk))
    coeff = pipe.model.apply(var, jnp.asarray(images), train=True,
                             mutable=["batch_stats"])[0]
    tri_id = render_coeffs(split_coeff(coeff, cfg), pipe.bfm, cfg).tri_id
    return dict(images=images, lmk=lmk, var=var, tri_id=np.asarray(tri_id),
                parts={k: float(v) for k, v in parts.items()},
                grads=grads, stats=stats,
                params2=jtu.tree_map(np.asarray,
                                     second.variables["params"]))


def test_train_step_matches_reference(cfg, assets, reference_step):
    ref = reference_step
    pipe = make_train_pipeline(cfg, assets, device="cpu",
                               dtype=torch.float32, depth=18)
    pipe.model.load_state_dict(jax_params.train_state_dict(ref["var"]))
    before = {k: v.clone() for k, v in pipe.model.named_parameters()}
    with torch.no_grad():
        coeff = pipe.model(torch.tensor(ref["images"]))
        tri_id = t_render_coeffs(t_split_coeff(coeff, cfg), pipe.bfm,
                                 cfg).tri_id.numpy()
    assert (tri_id >= 0).mean() > 0.1
    assert (tri_id == ref["tri_id"]).mean() >= 0.999
    pipe.model.load_state_dict(jax_params.train_state_dict(ref["var"]))
    state = TT.TrainState(*TT.make_optimizer(cfg, pipe.model.parameters(),
                                             50))
    parts = TT.make_train_step(pipe)(state, torch.tensor(ref["images"]),
                                     torch.tensor(ref["lmk"]))
    assert state.step == 1
    assert set(parts) == set(ref["parts"])
    for k, v in ref["parts"].items():
        assert abs(float(parts[k]) - v) <= 1e-4 * abs(v) + 1e-9, k
    assert ref["parts"]["photo"] > 0.01

    want = jax_params.train_state_dict(
        {"params": ref["grads"], "batch_stats": ref["stats"]})
    n_checked = n_live = 0
    for name, p in pipe.model.named_parameters():
        g_ref = want[name]
        scale = float(g_ref.abs().max())
        # exactly zero where the reference's is (the branches behind a
        # zero BN scale), else within 1e-3 of the tensor's max
        assert float((p.grad - g_ref).abs().max()) <= 1e-3 * scale, name
        n_live += scale > 0
        # the first update's rate is sched(0) = 0
        assert torch.equal(p.detach(), before[name]), name
        n_checked += 1
    assert n_checked == len(list(pipe.model.parameters()))
    assert n_live >= 20
    for name, buf in pipe.model.named_buffers():
        assert float((buf - want[name]).abs().max()) <= 1e-5, name

    # the second update, at lr = sched(1) > 0, on the same batch: both
    # gradients repeat the first, so each element moves by
    # lr * g / (|g| + eps) after bias correction. Where |g| clears the
    # gradient bar, the signs agree and the moves match to 1e-3 x lr
    TT.make_train_step(pipe)(state, torch.tensor(ref["images"]),
                             torch.tensor(ref["lmk"]))
    assert state.step == 2
    lr = TT.lr_schedule(cfg, 50)(1)
    assert lr > 0
    want2 = jax_params.train_state_dict(
        {"params": ref["params2"], "batch_stats": ref["stats"]})
    n_sure = 0
    for name, p in pipe.model.named_parameters():
        g_ref, p_ref = want[name], want2[name]
        step_ref = p_ref - before[name]
        step = p.detach() - before[name]
        ulps = 2 * torch.tensor(np.spacing(np.abs(p_ref.numpy())))
        sure = g_ref.abs() > 2e-3 * float(g_ref.abs().max())
        assert bool(((step - step_ref).abs() <= 1e-3 * lr + ulps)[sure]
                    .all()), name
        assert bool(((step - step_ref).abs() <= 2 * lr + ulps).all()), name
        n_sure += int(sure.sum())
    assert n_sure > 1000
