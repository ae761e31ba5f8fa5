"""The whole inference slice at tiny_config(): the port's
Pipeline.reconstruct (float32 model, CPU) against the reference's
make_reconstruct_fn(inference=True) with the same carried weights.

Bars: coefficient vector to 1e-4 x max|coeff| (CPU convolutions differ
in algorithm and order); vertex MAE < 1e-5; tri_id equal on >= 99.9% of
pixels (the reference's CPU render path is rasterize_tiled + shade_packed
on vertices that differ by ulps); image to 1e-3 where tri_id agrees.
"""

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch

from facerecon_tpu.models.fused import build_fused_model
from facerecon_tpu.ops.geometry import device_bfm
from facerecon_tpu.pipeline import Pipeline, make_reconstruct_fn

from facerecon_tpu_torch import jax_params
from facerecon_tpu_torch.data.synthetic import sample_coeffs
from facerecon_tpu_torch.pipeline import make_pipeline

torch.set_num_threads(2)


def _fused_params(cfg, images):
    """Random fused-model params (flax layout, numpy): LeCun-normal convs
    with small biases, and a head whose bias is one sample_coeffs draw and
    whose kernel adds a per-image variation of std 0.02, so the
    coefficients stay in sample_coeffs's range and the face stays in
    frame."""
    model = build_fused_model(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    rng = np.random.default_rng(0)

    def leaf(path, s):
        n = rng.standard_normal(s.shape)
        if "kernel" in jtu.keystr(path[-1:]):
            n = n / np.sqrt(np.prod(s.shape[:-1]))
        else:
            n = 0.01 * n
        return n.astype(np.float32)

    params = jtu.tree_map_with_path(leaf, dict(shapes))
    params["head"]["bias"] = np.zeros_like(params["head"]["bias"])
    # scale the head kernel by the spread it gives on these images
    probe = np.asarray(model.apply({"params": params}, jnp.asarray(images)))
    params["head"]["kernel"] *= np.float32(0.02 / probe.std())
    params["head"]["bias"] = sample_coeffs(rng, cfg, 1)[0]
    return params


def test_reconstruct_matches_reference(cfg, assets):
    images = np.random.default_rng(1).random(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    params = _fused_params(cfg, images)

    ref_pipe = Pipeline(cfg=cfg, bfm=device_bfm(assets),
                        model=build_fused_model(cfg, dtype=jnp.float32))
    fn = make_reconstruct_fn(ref_pipe, inference=True)
    cv_ref, _, out_ref = fn({"params": params}, ref_pipe.bfm,
                            jnp.asarray(images))

    pipe = make_pipeline(cfg, assets, device="cpu", dtype=torch.float32)
    pipe.model.load_state_dict(jax_params.fused_state_dict(params))
    cv, coeffs, out = pipe.reconstruct(images)

    cv_ref = np.asarray(cv_ref)
    scale = float(np.abs(cv_ref).max())
    assert float(np.abs(cv.numpy() - cv_ref).max()) < 1e-4 * scale
    assert coeffs.id.shape == (2, cfg.n_id)
    vmae = np.abs(out.geometry.verts_world.numpy()
                  - np.asarray(out_ref.geometry.verts_world)).mean()
    assert vmae < 1e-5
    tid, tid_ref = out.tri_id.numpy(), np.asarray(out_ref.tri_id)
    assert (tid >= 0).mean() >= 0.1 and (tid_ref >= 0).mean() >= 0.1
    same = tid == tid_ref
    assert same.mean() >= 0.999
    img, img_ref = out.image.numpy(), np.asarray(out_ref.image)
    assert img.shape == img_ref.shape == images.shape
    np.testing.assert_allclose(img[same], img_ref[same], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(out.mask.numpy(), (tid >= 0))
    # background pixels carry the input image through the composite
    np.testing.assert_array_equal(img[tid < 0], images[tid < 0])


def test_reconstruct_on_a_train_pipeline_runs_in_eval_mode(cfg, assets):
    """After a training step, reconstruct on the BatchNorm pipeline
    normalises with the running statistics and leaves them bit for bit
    as they were (the reference's reconstruct applies train=False); its
    coefficients are regress_coeffs(train=False)'s, and the model's mode
    is what it was before."""
    from facerecon_tpu_torch.data.synthetic import render_batch
    from facerecon_tpu_torch.pipeline import (make_train_pipeline,
                                              regress_coeffs)
    from facerecon_tpu_torch.train import init_state, make_train_step
    pipe = make_train_pipeline(cfg, assets, device="cpu",
                               dtype=torch.float32, depth=18)
    state = init_state(pipe, total_steps=50)
    gt = sample_coeffs(np.random.default_rng(0), cfg, 2)
    images, lmk = render_batch(gt, pipe.bfm, cfg)
    make_train_step(pipe)(state, images, lmk)
    assert pipe.model.training

    def stats():
        return {n: b.clone() for n, b in pipe.model.named_buffers()
                if n.endswith(("running_mean", "running_var"))}

    before = stats()
    assert before
    cv, _, out = pipe.reconstruct(images)
    assert pipe.model.training
    after = stats()
    assert all(torch.equal(before[n], after[n]) for n in before)
    with torch.no_grad():
        ref = regress_coeffs(pipe, images, train=False)
    assert torch.equal(cv, ref)
    assert float(out.mask.mean()) > 0.1
    # the eval-mode pipeline keeps its mode too
    pipe.model.eval()
    pipe.reconstruct(images)
    assert not pipe.model.training


def test_entry_points_need_a_card_unless_asked_for_cpu(cfg, assets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pipeline(cfg, assets)
    from facerecon_tpu_torch.ops.geometry import device_bfm as t_device_bfm
    with pytest.raises(RuntimeError):
        t_device_bfm(assets)

