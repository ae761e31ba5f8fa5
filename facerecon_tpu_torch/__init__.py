"""PyTorch/CUDA port of facerecon_tpu for NVIDIA Hopper.

The JAX package `facerecon_tpu` stays the reference; this package mirrors
its layout module by module and imports nothing of it. Plain tensor code
is PyTorch; the rasterizer's hot loop is a hand-written CUDA kernel
(`csrc/raster_shade.cu`, built at first use by `ops/_build.py`).

Entry points (`pipeline.make_pipeline`, `ops.geometry.device_bfm`) run
on the card unless the caller passes `device="cpu"`.
"""

import torch


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU.
    Raises when a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "facerecon_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the host")
    return dev
