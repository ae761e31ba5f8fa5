"""On the card: one short run of each cell through the harness, correct
against the reference, with the device's name and peak memory.

  python -m pytest -m cuda perfbench/tests/test_perfbench_cuda.py
"""

import pytest
import torch

from perfbench import run, spec

CELLS = ("infer224.b256", "train224.b128", "render512.b256",
         "infer224.frame")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(card, name):
    r = run.run_cell(spec.cell(name), 2 ** 31 + 77, 1.0, False, card)
    assert r["correct"], r["compared"]
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["kind"] == torch.cuda.get_device_name(card)
    assert r["device"]["memory_peak_bytes"] > 0
