"""Checkpoint/resume (twin of facerecon_tpu/checkpoint.py) — SURVEY.md §3
C22 / §6.

One file a step, `step_<n>.pt` under the directory, holding the training
state {"model": state_dict, "optimizer": ..., "scheduler": ..., "step":
int} as `torch.save` writes it. A save goes to a temporary name first and
is renamed into place with `os.replace`, so a run killed mid-save never
leaves a torn latest checkpoint; only the newest `max_to_keep` are kept.
The save is synchronous, so `wait` has nothing to wait for.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    """Save/restore/resume a training state dict, one file a step."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(_NAME.fullmatch,
                                                    os.listdir(self.directory))
                      if m)

    def save(self, step: int, state: Any) -> None:
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Any:
        """The state saved at `step` (the latest when None), its tensors
        on `map_location`."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in "
                                    f"{self.directory}")
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        """Holds no open resource."""


def restore_or_init(pipe, ckpt: Optional[str], seed: int = 0):
    """The pipeline's model with weights restored from the training
    checkpoint directory `ckpt` when given (the optimizer's state is
    ignored, as the reference's templateless restore ignores opt_state),
    else freshly initialised from `seed` (a BatchNorm model's zero head
    predicts the mean face). Returns pipe.model."""
    if ckpt:
        state = CheckpointManager(ckpt).restore()
        pipe.model.load_state_dict(state["model"])
    else:
        pipe.model.reset_parameters_(torch.Generator().manual_seed(seed))
    return pipe.model
