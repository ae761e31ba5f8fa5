"""The port's data parallelism (parallel/mesh.py) on the CPU: two ranks
of a gloo group, spawned processes (tests/torch_dist_workers.py), held
against the same code run in one process with no group, with
tests/test_sharding.py's bars:
  - one data-parallel train step (float32, depth 18, global batch 8,
    a small non-zero head so every layer gets a gradient): the loss rtol
    1e-5; parameters and the BatchNorm running statistics rtol 1e-4,
    atol 1e-6; the all-reduced gradients within 1e-4 x each tensor's max
    |g| (against the same step in float64, the single-process float32
    gradients lie up to 5.3e-5 of it away at 2 threads, the sharded
    ones 5.5e-6: other sums, other rounding). With
    BatchNorm's all-reduce of the moments patched out, the comparison
    fails;
  - the joint track solve on 8 frames sharded 4 + 4: losses rtol 1e-4,
    atol 1e-6; shared_id rtol 1e-3, atol 1e-4 (float32 sums over frames
    in another order);
  - the slices of mesh.shard_batch / shard_axis1.
The sharded renders, the drivers under a group and dryrun_multichip(2)
are in tests/test_torch_parallel_drivers.py.

graft_entry.entry(), the twin of the reference's __graft_entry__.entry(),
is held here too: the reference test's shapes
(tests/test_graft_entry.py), finite outputs, and against the reference's
entry() at its own shapes (224 px, batch 8 of zeros, the reference's
variables carried over): coefficients equal, landmarks within 1e-4 px,
tri_id agreement >= 99.9% and the image within 1e-4 where it agrees.
The port's single-process results are held against the reference in
tests/test_torch_train_step.py and tests/test_torch_track.py.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_graft
import facerecon_tpu.pipeline as ref_pipeline
import facerecon_tpu_torch.ops.render as port_render
import torch_dist_workers as W
from facerecon_tpu_torch import jax_params
from facerecon_tpu_torch.graft_entry import dryrun_multichip, entry
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.parallel import mesh

torch.set_num_threads(2)


def _close(got, want, rtol, atol, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def _compare_steps(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for part in ("params", "stats"):
        _close(got[part], want[part], 1e-4, 1e-6, part)
    for k, g in want["grads"].items():
        err = np.abs(got["grads"][k] - g).max()
        assert err <= 1e-4 * np.abs(g).max(), f"grads {k}: {err}"


@pytest.fixture(scope="module")
def single_steps():
    assert not mesh.grouped()
    return W.train_steps()


def test_sharded_train_step_matches_single(tmp_path, single_steps):
    ranks = W.run_ranks(W.train_steps, 2, tmp_path)
    for got in ranks:
        _compare_steps(got, single_steps)
    # the gradient reaches the stem through every BatchNorm (the first
    # update's rate is 0, as in the reference's schedule, so the
    # gradients and the running statistics carry the comparison)
    assert np.abs(single_steps["grads"]["stem.weight"]).max() > 0


def test_unsynced_batchnorm_breaks_the_match(tmp_path, single_steps):
    """Averaging the gradients alone is not the reference's step: with
    each rank normalising by its own moments the step differs."""
    ranks = W.run_ranks(W.train_steps, 2, tmp_path, False)
    with pytest.raises(AssertionError):
        _compare_steps(ranks[0], single_steps)
    # and each rank kept its own running statistics
    assert not all(np.array_equal(ranks[0]["stats"][k], ranks[1]["stats"][k])
                   for k in ranks[0]["stats"])


def test_sharded_joint_solve_matches_single(tmp_path):
    want = W.joint_solve()
    ranks = W.run_ranks(W.joint_solve, 2, tmp_path)
    for got in ranks:
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["shared_id"], want["shared_id"],
                                   rtol=1e-3, atol=1e-4)
    assert want["losses"][-1] < want["losses"][0]
    # the shared leaves stay equal over the ranks
    np.testing.assert_array_equal(ranks[0]["shared_id"],
                                  ranks[1]["shared_id"])
    np.testing.assert_array_equal(ranks[0]["per_frame"],
                                  ranks[1]["per_frame"])


def test_shard_slices_need_an_even_split(monkeypatch):
    x = np.arange(12).reshape(2, 6)
    assert mesh.shard_batch(x) is x            # no group: one rank
    monkeypatch.setattr(mesh, "world", lambda: 2)
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    np.testing.assert_array_equal(mesh.shard_batch(x), x[1:])
    np.testing.assert_array_equal(mesh.shard_axis1(x), x[:, 3:])
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(np.arange(5))


def test_dryrun_needs_a_card_a_rank():
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"needs {n} CUDA devices"):
        dryrun_multichip(n)


@pytest.fixture(scope="module")
def entries():
    """Both packages' entry() at their own shapes, the reference's
    variables carried into the port's model: each side's (coefficients,
    image, landmarks, tri_id) as numpy, plus the port's raw outputs and
    its kernels' launches. tri_id comes from a spy on the render each fn
    calls (the reference's fn runs unjitted outside; its reconstruct is
    jitted inside)."""
    seen = {}
    orig_recon, orig_render = (ref_pipeline.make_reconstruct_fn,
                               port_render.render_coeffs)

    def spy_recon(pipe, **kw):
        recon = orig_recon(pipe, **kw)

        def call(*args):
            res = recon(*args)
            seen["ref"] = res[2]
            return res
        return call

    def spy_render(*args, **kw):
        seen["port"] = orig_render(*args, **kw)
        return seen["port"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_pipeline, "make_reconstruct_fn", spy_recon)
        mp.setattr(port_render, "render_coeffs", spy_render)
        ref_fn, ref_args = ref_graft.entry()
        fn, args = entry(device="cpu")
    ref_cv, ref_image, ref_lmk = (np.asarray(x) for x in ref_fn(*ref_args))
    args[0].load_state_dict(jax_params.train_state_dict(
        jax.tree_util.tree_map(np.asarray, ref_args[0])))
    before = dict(_build.LAUNCHES)
    port = fn(*args)
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    ref = (ref_cv, ref_image, ref_lmk, np.asarray(seen["ref"].tri_id))
    got = tuple(x.detach().numpy() for x in port) + (
        seen["port"].tri_id.numpy(),)
    return ref, got, port, launched


def test_entry_runs_at_the_reference_tests_shapes(entries):
    _, _, (coeffs, image, lmk), launched = entries
    assert coeffs.shape == (8, 257)
    assert image.shape == (8, 224, 224, 3)
    assert lmk.shape == (8, 68, 2)
    for t in (coeffs, image, lmk):
        assert bool(torch.isfinite(t).all())
    # the differentiable render: the outputs carry the autograd graph
    assert coeffs.requires_grad and image.requires_grad
    assert not any(launched.values())       # the CPU takes the plain path


def test_entry_matches_reference_entry(entries):
    (rc, ri, rl, rt), (gc, gi, gl, gt), _, _ = entries
    np.testing.assert_array_equal(gc, rc)
    assert not rc.any()                   # the zero head: the mean face
    np.testing.assert_allclose(gl, rl, rtol=0, atol=1e-4)
    same = gt == rt
    assert (rt >= 0).mean() > 0.05
    assert same.mean() >= 0.999
    assert np.abs(gi - ri)[same].max() <= 1e-4
