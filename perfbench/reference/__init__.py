"""The plain reference: ResNet-50 regressor, 3DMM geometry, SH-9 shading,
a z-buffer rasterizer, the losses and Adam, in plain PyTorch float32
(TF32 off). It imports nothing of the program, and takes only what the
benchmark makes (weights, mesh arrays, inputs) and, to judge them, the
program's outputs.

`precision` selects the control's arithmetic: "f32" is the reference;
"tf32" rounds every matmul input to TF32's 10-bit mantissa; "fp8" also
quantizes every convolution's input and weight to float8 e4m3 with a
per-tensor scale (quant.py).
"""


def strict() -> None:
    """Float32 matmuls and convolutions in float32 on the card: TF32 off
    (PyTorch lets cuDNN use it by default)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
