"""The port's evaluate driver (facerecon_tpu_torch/evaluate.py) against
the JAX reference's (facerecon_tpu/evaluate.py) on the same arguments:
2 faces, tiny_config(), seed 0, on the CPU.

Bars: the same report keys; both meet the contract; the port's vertex
MAE < 1e-6 and tri_id agreement > 0.999 against the oracle; its render
PSNR within 0.5 dB of the reference's (both are > 100 dB: the images
agree to float32 rounding, so PSNR measures rounding noise); "backend"
names the torch device.
"""

import argparse
import json

import pytest
import torch

from facerecon_tpu import evaluate as ref_evaluate

from facerecon_tpu_torch import evaluate

torch.set_num_threads(2)


def test_evaluate_matches_reference(capsys):
    got = evaluate.run(2, tiny=True, seed=0, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == got
    ref = ref_evaluate.run(argparse.Namespace(
        faces=2, tiny=True, seed=0, bfm=None, platform=None))
    assert got.keys() == ref.keys()
    assert got["backend"] == "cpu" and got["faces"] == 2
    assert got["meets_contract"] and ref["meets_contract"]
    assert got["vertex_mae"] < 1e-6
    assert got["tri_id_agreement_min"] > 0.999
    assert got["render_psnr_db_min"] > 100
    assert abs(got["render_psnr_db_min"] - ref["render_psnr_db_min"]) < 0.5


def test_cli_and_device(capsys):
    """The CLI prints the report; --device cuda without a card raises
    (there is no fallback to the CPU)."""
    report = evaluate.main(["--faces", "1", "--tiny", "--device", "cpu",
                            "--seed", "3"])
    assert json.loads(capsys.readouterr().out.strip()) == report
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            evaluate.run(1, tiny=True)
