"""The work DECA's detail cell needs, counted from its shapes and inputs
whatever implements it, against the H100's data-sheet peaks (work.py).

- A face's FLOPs (`mfu`): FLAME's and the albedo decode's in float32
  (work_flame.flops_per_face, at work.PEAK_F32), plus the detail
  decoder's (`decoder_flops`: 2 a multiply-add of the linear layer and
  of every 3x3 convolution at its output size, 879,140,864 multiply-adds
  at DECA's widths) at the dense TF32 tensor-core peak, PEAK_TF32, half
  the bf16 peak work.py uses, as the configuration computes its
  convolutions in TF32.
- The UV detail kernel (`uv_detail_bytes`): bytes read once and written
  once. Per image the posed vertices and coarse normals (24 B a vertex)
  and per texel uv_z (4 B), the albedo (12 B) and the outputs (the
  texture and the detail normals, 12 B each, the displacement 4 B);
  once the texel table (16 B a texel: face id and three barycentrics),
  the fixed displacement and the mask (4 B a texel each).
- The detailed image's fetch (`texfetch_work`): work_flame.texture_work
  less the normal corners (12 B a vertex an image); its ops are the
  same needed tests (the textured kernel's shade counts none).
"""

from __future__ import annotations

import torch

from perfbench import work, work_flame

PEAK_TF32 = work.PEAK_BF16 / 2


def decoder_flops(cfgf: dict) -> int:
    dec = cfgf["decoder"]
    ch = dec["channels"]
    s = dec["start_size"]
    macs = dec["latent_dim"] * ch[0] * s * s
    for cin, cout in zip(ch[:-1], ch[1:]):
        s *= 2
        macs += s * s * cout * cin * 9
    macs += s * s * dec["out_channels"] * ch[-1] * 9
    return 2 * macs


def mfu(ctx):
    """Least seconds a face at each precision's peak over the window's
    seconds a face, in %."""
    kind = ctx["kind"]
    least = (work_flame.flops_per_face(kind.sizes, kind.n_vertices)
             / work.PEAK_F32 + decoder_flops(kind.cfgf) / PEAK_TF32)
    return 100.0 * least * ctx["faces"] / ctx["window_s"]


def uv_detail_bytes(batch: int, n_vertices: int, uv_size: int) -> int:
    texels = uv_size * uv_size
    return batch * (n_vertices * 24 + texels * 44) + texels * 24


def texfetch_work(codes, fl, size: int, uv_size: int):
    nbytes, ops = work_flame.texture_work(codes, fl, size, uv_size)
    return nbytes - codes.shape[0] * fl.v_template.shape[0] * 12, ops


def _roofline(ctx, symbol: str, bound):
    """100 x the mean bound of the traced microbatches x the launches
    over the kernel's device time."""
    tr = ctx.get("trace")
    kind = ctx["kind"]
    if tr is None or not kind.captured:
        return None
    launches, secs = tr.kernel_seconds(symbol)
    if launches == 0 or secs <= 0:
        return None
    with torch.no_grad():
        bounds = [bound(codes) for codes in kind.captured]
    return 100.0 * sum(bounds) / len(bounds) * launches / secs


def uv_roofline_pct(ctx):
    kind = ctx["kind"]
    return _roofline(ctx, "uv_detail_kernel", lambda codes: uv_detail_bytes(
        codes.shape[0], kind.n_vertices, kind.uv_size) / work.PEAK_BYTES)


def texfetch_roofline_pct(ctx):
    kind = ctx["kind"]
    return _roofline(ctx, "raster_texfetch_kernel",
                     lambda codes: work.bound_seconds(*texfetch_work(
                         codes, kind.fl, kind.size, kind.uv_size)))
