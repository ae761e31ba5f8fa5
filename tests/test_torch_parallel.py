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
The port's single-process results are held against the reference in
tests/test_torch_train_step.py and tests/test_torch_track.py.
"""

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from facerecon_tpu_torch.graft_entry import dryrun_multichip
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
