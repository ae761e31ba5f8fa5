"""The work DECA's render cell needs, counted from its shapes and inputs
whatever implements it, against the H100's data-sheet peaks (work.py).

- A face's float32 FLOPs (`flops_per_face`), 2 a multiply-add: FLAME's
  blendshapes (3N x (n_shape + n_exp)), pose correctives (3N x 36), the
  skinning (the joints J_regressor . v_shaped, 5 x N x 3; T = W . A, N x
  5 x 16; v = T . [v, 1], N x 3 x 4) and the decode of the S x S x 3
  albedo texels the image depends on (x n_tex).
- The textured shade (`texture_work`): bytes read once and written once
  and the float32 ops of the pixel-triangle tests the inputs need
  (work.needed_tests). Per image: the vertices' screen position, depth
  and world normal (24 B a vertex), each pixel's id, colour and
  barycentrics written (28 B), and the distinct albedo texels the
  covered pixels' bilinear footprints read (12 B each, in the texture);
  once: the UV vertices (8 B each) and the face and UV-face lists (12 B a
  face each).
"""

from __future__ import annotations

import torch

from perfbench import work
from perfbench.reference import deca

N_JOINTS = 5
N_CORRECTIVES = 36
BLOCK = 16


def flops_per_face(sizes: dict, n_vertices: int) -> int:
    n3 = 3 * n_vertices
    blend = n3 * (sizes["n_shape"] + sizes["n_exp"])
    correct = n3 * N_CORRECTIVES
    skin = (N_JOINTS * n_vertices * 3 + n_vertices * N_JOINTS * 16
            + n_vertices * 12)
    decode = sizes["uv_size"] ** 2 * 3 * sizes["n_tex"]
    return 2 * (blend + correct + skin + decode)


def mfu(ctx):
    """Least seconds a face at the float32 peak over the window's seconds
    a face, in %."""
    kind = ctx["kind"]
    least = flops_per_face(kind.sizes, kind.n_vertices) / work.PEAK_F32
    return 100.0 * least * ctx["faces"] / ctx["window_s"]


def distinct_texels(uv, hit, size: int) -> int:
    """Texels inside the S x S texture that the bilinear footprints of
    one image's covered pixels touch: uv (P, 2) grid coordinates, hit (P,)
    bool."""
    g = uv[hit]
    ix = torch.floor(((g[:, 0] + 1.0) * size - 1.0) / 2.0).to(torch.int64)
    iy = torch.floor(((g[:, 1] + 1.0) * size - 1.0) / 2.0).to(torch.int64)
    xs = torch.stack([ix, ix + 1, ix, ix + 1], 1).reshape(-1)
    ys = torch.stack([iy, iy, iy + 1, iy + 1], 1).reshape(-1)
    inb = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
    return int(torch.unique(ys[inb] * size + xs[inb]).numel())


def texture_work(codes, fl, size: int, uv_size: int):
    """(bytes, f32 ops) of one launch over the batch of DECA codes
    `codes`, from the reference's render of it (reference/deca.py, in
    blocks of BLOCK faces)."""
    n_v = fl.v_template.shape[0]
    n_faces = fl.faces.shape[0]
    nbytes = fl.uvcoords.shape[0] * 8 + 2 * n_faces * 12
    ops = 0
    for i in range(0, codes.shape[0], BLOCK):
        blk = codes[i:i + BLOCK]
        r = deca.render(blk, fl, size, uv_size)
        trans = deca.batch_orth_proj(r.verts, deca.split(blk)["cam"])
        screen = torch.stack([trans[..., 0] + 1.0, 1.0 - trans[..., 1]],
                             -1) * (size / 2.0)
        ops += work.needed_tests(screen, fl.faces, size, size)[1]
        texels = sum(distinct_texels(r.uv[b].reshape(-1, 2),
                                     (r.tri_id[b] >= 0).reshape(-1), uv_size)
                     for b in range(blk.shape[0]))
        nbytes += blk.shape[0] * (n_v * 24 + size * size * 28) + texels * 12
    return nbytes, ops


def roofline_pct(ctx, symbol: str):
    """The function's least time over the kernel's device time in the
    trace, in %: the bound of each launch from the codes its microbatch
    rendered, averaged, times the launches in the trace."""
    tr = ctx.get("trace")
    kind = ctx["kind"]
    if tr is None or not kind.captured:
        return None
    launches, secs = tr.kernel_seconds(symbol)
    if launches == 0 or secs <= 0:
        return None
    with torch.no_grad():
        bounds = [work.bound_seconds(*texture_work(
            codes, kind.fl, kind.size, kind.uv_size))
            for codes in kind.captured]
    return 100.0 * sum(bounds) / len(bounds) * launches / secs
