"""The port's data parallelism on the CPU, part two: two ranks of a gloo
group (spawned, tests/torch_dist_workers.py) against the same code in
one process with no group:
  - render_batch sharded over the batch at 64 px and at 512 px
    (tiny_config(image_size=512, tile_h=1), tests/test_sharding.py:29-58):
    images and landmarks rtol 1e-5, atol 1e-5 / 1e-4;
  - the track and train drivers under a group: track shards its frames
    and reports the global loss (rtol 1e-4), train logs the global loss
    (rtol 1e-5) and rank 0 alone writes the checkpoint;
  - dryrun_multichip(2) over gloo prints the reference's line;
  - the train driver's sources, sharded as a rank shards them, load only
    that rank's slice of each global batch, and the slices of the ranks
    make up the one-process batches.
"""

import itertools
import os

import numpy as np
import pytest
import torch
from PIL import Image

import torch_dist_workers as W
from facerecon_tpu_torch.config import tiny_config
from facerecon_tpu_torch.data.folder import FolderDataset
from facerecon_tpu_torch.data.synthetic import synthetic_batches
from facerecon_tpu_torch.graft_entry import dryrun_multichip
from facerecon_tpu_torch.ops.geometry import device_bfm
from facerecon_tpu_torch.utils.bfm import synthetic_bfm

torch.set_num_threads(2)


@pytest.mark.parametrize("size,seed", [(64, 0), (512, 4)],
                         ids=["64px", "512px"])
def test_sharded_render_matches_single(tmp_path, size, seed):
    want = W.render(size, seed)
    assert want["images"].shape == (8, size, size, 3)
    for got in W.run_ranks(W.render, 2, tmp_path, size, seed):
        np.testing.assert_allclose(got["images"], want["images"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["lmk"], want["lmk"], rtol=1e-5,
                                   atol=1e-4)


def test_drivers_under_a_group(tmp_path):
    """track.run shards its 4 frames 2 + 2 and reports the global loss;
    train.run (--chunk 2, each rank rendering its slice of every batch)
    logs the global loss and rank 0 alone writes the checkpoint."""
    want = W.drivers(tmp_path / "single")
    ranks = W.run_ranks(W.drivers, 2, tmp_path, tmp_path)
    for got in ranks:
        assert got["track"]["devices"] == 2 and want["track"]["devices"] == 1
        for k in ("loss_first", "loss_last"):
            assert got["track"][k] == pytest.approx(want["track"][k],
                                                    rel=1e-4)
        for k in ("first_loss", "last_loss"):
            assert got["train"][k] == pytest.approx(want["train"][k],
                                                    rel=1e-5)
        assert got["saved"] == want["saved"] == [2]


def test_dryrun_multichip_two_ranks(capsys):
    loss = dryrun_multichip(2, device="cpu")
    assert np.isfinite(loss)
    assert (f"dryrun_multichip(2): one sharded train step OK, "
            f"loss={loss:.4f}") in capsys.readouterr().out


def _rank_slice(r, n=2):
    """mesh.shard_batch as rank r of n takes it."""
    return lambda x: x[r * len(x) // n:(r + 1) * len(x) // n]


@pytest.mark.parametrize("source", ["synthetic", "pool", "folder"])
def test_sources_load_only_their_shard(tmp_path, monkeypatch, source):
    cfg = tiny_config()
    if source == "folder":
        rng = np.random.default_rng(0)
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (48, 40, 3), np.uint8)).save(
                tmp_path / f"f{i}.png")
            np.savetxt(tmp_path / f"f{i}.txt", rng.uniform(0, 40, (68, 2)))
        decoded = []
        load = FolderDataset.load
        monkeypatch.setattr(FolderDataset, "load", lambda self, j: (
            decoded.append(j), load(self, j))[1])
        ds = FolderDataset(str(tmp_path), cfg, align="none")

        def make(shard=None):
            return ds.batches(4, seed=3, epochs=2, shard=shard)
    else:
        bfm = device_bfm(synthetic_bfm(cfg, 0), "cpu")

        def make(shard=None):
            return synthetic_batches(bfm, cfg, 4, seed=3,
                                     pool=2 if source == "pool" else 0,
                                     shard=shard)
    n = 4
    want = list(itertools.islice(make(), n))
    got = []
    for r in (0, 1):
        first = len(decoded) if source == "folder" else 0
        got.append(list(itertools.islice(make(_rank_slice(r)), n)))
        if source == "folder":          # a rank decodes its half alone
            assert len(decoded) - first == 2 * n
    for b in range(n):
        for k in (0, 1):
            parts = [got[r][b][k] for r in (0, 1)]
            assert all(p.shape[0] == 2 for p in parts)
            np.testing.assert_allclose(
                np.concatenate([np.asarray(p) for p in parts]),
                np.asarray(want[b][k]), rtol=1e-5, atol=1e-5)
