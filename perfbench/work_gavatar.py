"""The work GaussianAvatars' render cell needs, counted from its shapes
and the traced unit's inputs whatever implements it, against the H100's
data-sheet peaks (work.py). The splat's counts come from the plain
reference's render of the traced codes (reference/gaussian_avatar.py), in
blocks of frames, not from the program's buffers.

- A frame's float32 FLOPs (`flame_flops`), 2 a multiply-add: FLAME's
  blendshapes (3N x (n_shape + n_exp)), pose correctives (3N x 36) and
  skinning (the joints, T = W . A, v = T . [v, 1]), as work_flame counts
  them.
- The preprocess (`prep_work`, the kernel gauss_prep): bytes the
  Gaussians' parameters once a microbatch (59 floats and the binding),
  the posed vertices (12 B each a frame), the faces (12 B each) and the
  cameras once, and per frame and Gaussian what it writes: the world mean
  (12 B), the blend's record (36 B), the depth, the radius and the tile
  count (4 B each); ops PREP_OPS a frame and Gaussian (the triangle frame
  78, the binding 21, the covariance 90, the view 18, the EWA 80, the
  conic and radius 20, the pixel and rectangle 20, SH-3 146) and
  PREP_ONCE a Gaussian (the activations and the local rotation).
- The blend (`splat_work`, the kernel gauss_blend): bytes the sorted ids
  (4 B a pair), each pair's record read once by its tile (36 B), and the
  image and alpha written (16 B a pixel); ops TEST_OPS for each pair test
  a pixel makes up to its own cut-off (the offset, the power, the exp,
  the alpha and its two tests) and TAKE_OPS for each Gaussian it takes
  (the transmittance and the colour).
Both kernels' ops are counted at the float32 peak, 67e12.
"""

from __future__ import annotations

import torch

from perfbench import work, work_flame
from perfbench.reference import gaussian_avatar as ga

PREP_OPS = 473
PREP_ONCE = 60
PREP_OUT = 12 + 36 + 4 + 4 + 4
PARAM_BYTES = 59 * 4 + 4
TEST_OPS = 15
TAKE_OPS = 12
PAIR_BYTES = 4 + 36
PIXEL_BYTES = 16


def flame_flops(sizes: dict, n_vertices: int) -> int:
    return work_flame.flops_per_face(dict(sizes, n_tex=0, uv_size=0),
                                     n_vertices)


def prep_work(frames: int, sizes: dict):
    """(bytes, f32 ops) of one gauss_prep launch over `frames` frames."""
    g, n, f = sizes["n_gaussians"], sizes["n_vertices"], sizes["n_faces"]
    nbytes = (g * PARAM_BYTES + frames * n * 12 + f * 12 + frames * 14 * 4
              + frames * g * PREP_OUT)
    return nbytes, frames * g * PREP_OPS + g * PREP_ONCE


def splat_work(codes, av, hw, background):
    """(bytes, f32 ops) of one gauss_blend launch over codes (B, 432):
    the reference's pairs, and its pixels' tests and takes."""
    pairs = tests = taken = 0
    for _, r in ga.render_blocks(codes, av, *hw, background, flags=False):
        pairs += int(r.pairs)
        tests += int(r.tests.sum())
        taken += int(r.taken.sum())
    nbytes = pairs * PAIR_BYTES + codes.shape[0] * hw[0] * hw[1] * PIXEL_BYTES
    return nbytes, tests * TEST_OPS + taken * TAKE_OPS


def counts(ctx):
    """Per microbatch of the traced unit: (prep (bytes, ops), splat (bytes,
    ops)), read once a run; None without a trace."""
    kind = ctx["kind"]
    if ctx.get("trace") is None or not kind.captured:
        return None
    if getattr(kind, "work", None) is None:
        with torch.no_grad():
            kind.work = [(prep_work(c.shape[0], kind.sizes),
                          splat_work(c, kind.av, kind.hw, kind.background))
                         for c in kind.captured]
    return kind.work


def roofline_pct(ctx, symbol: str, which: int):
    """The function's least time over the kernel's device time in the
    trace, in %: each launch's bound from its microbatch, averaged, times
    the launches (which: 0 the preprocess, 1 the blend)."""
    tr = ctx.get("trace")
    got = counts(ctx)
    if got is None:
        return None
    launches, secs = tr.kernel_seconds(symbol)
    if launches == 0 or secs <= 0:
        return None
    bounds = [work.bound_seconds(*c[which]) for c in got]
    return 100.0 * sum(bounds) / len(bounds) * launches / secs


def mfu(ctx):
    """FLAME's FLOPs and both kernels' ops a frame at the float32 peak,
    over the window's seconds a frame, in %."""
    got = counts(ctx)
    if got is None:
        return None
    kind = ctx["kind"]
    frames = sum(c.shape[0] for c in kind.captured)
    ops = sum(p[1] + s[1] for p, s in got) / frames
    least = (flame_flops(kind.sizes, kind.n_vertices) + ops) / work.PEAK_F32
    return 100.0 * least * ctx["faces"] / ctx["window_s"]
