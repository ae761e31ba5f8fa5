"""What this card delivers (twin of benchmarks/roofline_probe.py): the
HBM copy rate, the bf16 matmul rate and the chained timer's fixed cost,
each printed beside the data-sheet figure it stands in for. The port's
kernel bounds divide by data-sheet rates (chip_smoke.H100_BYTES_S); this
says how far the card falls short of them.

  python -m facerecon_tpu_torch.benchmarks.roofline_probe

- copy+sum: x * (1 + eps) of a 1 GiB f32 tensor (256, 1024, 1024) read
  and written whole, then the sum of its first 8 of every 1024 columns:
  (2 x 1 GiB + 8/1024 GiB) a call, the reference's bytes formula.
- matmul: 8192^3 bf16, through torch.matmul (the library's rate is the
  question), f32 accumulation, the product summed in f32. cuBLAS writes
  the product in bf16 where XLA wrote f32: 128 MiB less traffic on a
  1.1 TFLOP call.
- empty body: the sum of an (8, 128) f32 zero tensor.

Data-sheet figures: NVIDIA H100 SXM, 3.35e12 B/s HBM3 and 989e12 bf16
dense FLOP/s, at 700 W. The data is made on the device from a seeded
torch.Generator. `--device` (default cuda) raises without a card unless
it is "cpu"; the sizes are the module's BIG and MM.
"""

from __future__ import annotations

import argparse
import functools

import torch

from facerecon_tpu_torch.bench import _device
from facerecon_tpu_torch.benchmarks import _timing

INNER, REPS = 16, 3
LINE = "{tag:34s}: {ms:8.3f} ms  [compile {ct:.0f}s]"
BIG = (256, 1024, 1024)          # f32: 1 GiB
MM = 8192
SHEET_BYTES_S = 3.35e12          # H100 SXM data sheet, HBM3
SHEET_BF16_S = 989e12            # H100 SXM data sheet, bf16 dense


def make_inputs(device):
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    big = torch.rand(BIG, generator=g, device=dev)
    a = torch.rand((MM, MM), generator=g, device=dev, dtype=torch.bfloat16)
    b = torch.rand((MM, MM), generator=g, device=dev, dtype=torch.bfloat16)
    return big, a, b


def copy_sum(x):
    return x[:, :, :8].sum()


def matmul_sum(x, y):
    return torch.matmul(x, y).sum(dtype=torch.float32)


def empty(x):
    return x.sum()


def run(big, a, b):
    """The three cases and their rates; returns the Cases."""
    cases = []
    timed = functools.partial(_timing.timed, inner=INNER, reps=REPS,
                              line=LINE, cases=cases)
    t = timed("copy+sum 1GB f32", copy_sum, big)
    n_bytes = 2 * big.nbytes + big.nbytes * 8 / big.shape[-1]
    print(f"  -> approx HBM: {n_bytes / t / 1e9:.0f} GB/s (1GB read + 1GB "
          f"write), {n_bytes / t / SHEET_BYTES_S:.3f} of the data sheet's "
          f"{SHEET_BYTES_S / 1e9:.0f} GB/s", flush=True)
    t = timed(f"matmul {a.shape[0]}^3 bf16", matmul_sum, a, b)
    flops = 2 * a.shape[0] * a.shape[1] * b.shape[1]
    print(f"  -> approx tensor cores: {flops / t / 1e12:.1f} TFLOP/s bf16, "
          f"{flops / t / SHEET_BF16_S:.3f} of the data sheet's "
          f"{SHEET_BF16_S / 1e12:.0f}", flush=True)
    tiny = torch.zeros((8, 128), device=big.device)
    t = timed("empty body", empty, tiny)
    print(f"  -> harness fixed cost {t*1000:.3f} ms/iteration", flush=True)
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    return run(*make_inputs(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
