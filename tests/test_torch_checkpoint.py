"""The port's checkpoints (checkpoint.py) and the trainer's driver on the
CPU at tiny_config(): resume (train.save_state / restore_state,
--ckpt-dir / --resume), --data-dir, --chunk, the uint8 wire and
--tensorboard; plus the reference's round trip
(tests/test_pipeline_and_drivers.py:62-77) and training on a data folder
(tests/test_folder_dataset.py:88) on the port.

Bars: every restored tensor, the optimizer's and the schedule's states
and the step count EQUAL the saved ones bit for bit; a run resumed after
2 steps takes its next learning rate, and its next step's parameters, bit
for bit from where the uninterrupted run is.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from facerecon_tpu_torch import train as TT
from facerecon_tpu_torch.checkpoint import CheckpointManager, restore_or_init
from facerecon_tpu_torch.config import tiny_config
from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu_torch.pipeline import make_train_pipeline

from test_torch_data import write_photo_folder

torch.set_num_threads(2)


def _pipe(cfg, assets, seed=0):
    return make_train_pipeline(cfg, assets, device="cpu",
                               dtype=torch.float32, depth=18, seed=seed)


def _equal(a, b, where=""):
    """Nested state dicts equal bit for bit (tensors, numbers, lists)."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_checkpoint_roundtrip(tmp_path, cfg, assets):
    pipe = _pipe(cfg, assets)
    state = TT.init_state(pipe, total_steps=10)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    payload = {"model": pipe.model.state_dict(), "step": 7}
    mgr.save(7, payload)
    mgr.wait()
    restored = mgr.restore()
    assert restored["step"] == 7 and mgr.latest_step() == 7
    _equal(restored["model"], payload["model"])
    assert state.step == 0
    mgr.close()


def test_manager_keeps_the_newest_and_leaves_no_temp(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        mgr.restore()
    assert mgr.latest_step() is None
    for step in (3, 10, 7, 12):
        mgr.save(step, {"x": torch.full((2,), float(step)), "step": step})
    assert mgr.steps() == [10, 12]
    assert sorted(os.listdir(mgr.directory)) == ["step_10.pt", "step_12.pt"]
    assert float(mgr.restore(10)["x"][0]) == 10.0
    # a save killed before its rename leaves only a temporary file, which
    # is never taken for a checkpoint
    open(os.path.join(mgr.directory, "step_99.pt.tmp"), "wb").close()
    assert mgr.latest_step() == 12
    assert mgr.restore()["step"] == 12


def test_restore_or_init(tmp_path, cfg, assets):
    """With a checkpoint: the model's weights from it (the optimizer's
    state is ignored); without: the fresh initialisation from the seed
    (a zero head, so the mean face)."""
    trained = _pipe(cfg, assets, seed=3)
    with torch.no_grad():
        trained.model.head.bias.add_(0.5)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(5, {"model": trained.model.state_dict(),
                 "optimizer": {"state": {}, "param_groups": []}, "step": 5})
    pipe = _pipe(cfg, assets, seed=0)
    assert restore_or_init(pipe, str(tmp_path / "ck")) is pipe.model
    _equal(pipe.model.state_dict(), trained.model.state_dict())
    fresh = _pipe(cfg, assets, seed=4)
    restore_or_init(pipe, None, seed=4)
    _equal(pipe.model.state_dict(), fresh.model.state_dict())
    assert not pipe.model.head.bias.detach().any()


def test_resume_is_bit_exact(tmp_path, cfg, assets):
    """Two steps, a checkpoint, a fresh trainer restored from it: model,
    Adam, schedule and step equal the saved ones bit for bit, the next
    learning rate is the uninterrupted run's, and so is the next step."""
    total = 40
    gt = sample_coeffs(np.random.default_rng(0), cfg, 2)
    pipe = _pipe(cfg, assets)
    images, lmk = render_batch(gt, pipe.bfm, cfg)
    state = TT.init_state(pipe, total, seed=0)
    step = TT.make_train_step(pipe)
    for _ in range(2):
        step(state, images, lmk)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    TT.save_state(mgr, pipe, state)
    saved = mgr.restore()

    other = _pipe(cfg, assets, seed=9)
    resumed = TT.init_state(other, total, seed=9)
    TT.restore_state(mgr, other, resumed)
    assert resumed.step == state.step == 2
    _equal(other.model.state_dict(), saved["model"])
    _equal(resumed.optimizer.state_dict(), saved["optimizer"])
    _equal(resumed.scheduler.state_dict(), saved["scheduler"])
    _equal(other.model.state_dict(), pipe.model.state_dict())
    lr = resumed.optimizer.param_groups[0]["lr"]
    assert lr == state.optimizer.param_groups[0]["lr"]
    assert lr == pytest.approx(TT.lr_schedule(cfg, total)(2), rel=1e-12)
    assert lr > 0

    a = step(state, images, lmk)
    b = TT.make_train_step(other)(resumed, images, lmk)
    assert torch.equal(a["total"], b["total"])
    _equal(other.model.state_dict(), pipe.model.state_dict())


def test_train_driver_saves_and_resumes(tmp_path, capsys, monkeypatch):
    """--ckpt-dir saves every cfg.checkpoint_every iterations and at the
    end; --resume goes on from the latest step."""
    cfg = dataclasses.replace(tiny_config(), checkpoint_every=2)
    monkeypatch.setattr(TT, "tiny_config", lambda: cfg)
    ck = str(tmp_path / "ck")
    argv = ["--tiny", "--device", "cpu", "--batch", "2", "--data-pool", "1",
            "--log-every", "1", "--ckpt-dir", ck]
    TT.run(TT.parse_args(argv + ["--steps", "3"]))
    mgr = CheckpointManager(ck)
    assert mgr.steps() == [2, 3]
    first = mgr.restore()
    capsys.readouterr()
    report = TT.run(TT.parse_args(argv + ["--steps", "2", "--resume"]))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed at step 3"
    assert [json.loads(x)["step"] for x in out[1:3]] == [1, 2]
    assert report["steps"] == 2
    assert mgr.steps() == [2, 3, 5]
    last = mgr.restore()
    assert last["step"] == 5
    assert last["scheduler"]["last_epoch"] == 5
    assert first["scheduler"]["last_epoch"] == 3
    # the optimizer's update count went on too
    counts = {int(s["step"]) for s in last["optimizer"]["state"].values()}
    assert counts == {5}


# --- the trainer's other driver behaviour ---

def test_train_on_data_dir(tmp_path, cfg, assets):
    """tests/test_folder_dataset.py:88 on the port."""
    root, _, _ = write_photo_folder(tmp_path / "photos", cfg, assets, n=8)
    report = TT.main(["--tiny", "--device", "cpu", "--steps", "3", "--batch",
                      "8", "--data-dir", root, "--align", "68pt",
                      "--log-every", "1"])
    assert np.isfinite(report["last_loss"])


def test_chunk_rounds_steps_down(capsys):
    """--chunk 2 --steps 5 runs 4 steps, logs (i+1)*k, with the
    reference's message; the rate leaves out min(3, n_iters-1)
    iterations."""
    report = TT.main(["--tiny", "--device", "cpu", "--steps", "5",
                      "--chunk", "2", "--batch", "2", "--log-every", "1",
                      "--data-pool", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("--steps 5 is not a multiple of --chunk 2: "
                      "running 4 steps")
    lines = [json.loads(x) for x in out[1:]]
    assert [x["step"] for x in lines[:-1]] == [2, 4]
    assert all(np.isnan(x["faces_per_sec"]) for x in lines[:-1])
    assert lines[-1] == report and report["steps"] == 5


def test_u8_wire_clips_before_quantizing():
    host = np.array([[[[1.2, -0.3, 0.5]]]], np.float32)
    wire = TT.host_wire(host)
    assert wire.dtype == np.uint8
    np.testing.assert_array_equal(wire.flatten(), [255, 0, 128])
    got = TT.stage_images(wire, torch.device("cpu"))
    assert got.dtype == torch.float32
    want = np.array([255, 0, 128], np.float32) / np.float32(255)
    np.testing.assert_array_equal(got.flatten().numpy(), want)
    np.testing.assert_array_equal(
        TT.stage_images(TT.host_wire(host, wire_u8=False),
                        torch.device("cpu")).numpy(), host)
    on_device = torch.full((1, 2, 2, 3), 1.2)
    assert TT.host_wire(on_device) is on_device
    assert TT.stage_images(on_device, torch.device("cpu")) is on_device


def test_tensorboard_writes_events(tmp_path, capsys):
    tb = tmp_path / "tb"
    TT.main(["--tiny", "--device", "cpu", "--steps", "2", "--batch", "2",
             "--log-every", "1", "--data-pool", "1", "--tensorboard",
             str(tb)])
    assert "unavailable" not in capsys.readouterr().out
    events = glob.glob(str(tb / "events.out.tfevents.*"))
    assert len(events) == 1 and os.path.getsize(events[0]) > 0
