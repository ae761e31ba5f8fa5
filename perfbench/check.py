"""The comparison that decides `correct`: what the timed path produced,
judged against the plain reference (reference/), each number beside its
limit from the cell's traffic file.

Inference and render cells (`judge_render`): the reference regresses the
coefficients from the same images and leaves (float32, BatchNorm from
its running statistics), and renders from the program's coefficients;
so each stage is judged on what the program handed the next:
  coef_gap      worst image and group: RMS of (program - reference) over
                the group, over the group's spread in sample_coeffs
  vert_gap      largest |program - reference| of a posed vertex (world)
  lmk_gap_px    largest |program - reference| of a landmark (pixels)
  tri_mismatch  share of the pixels either covers whose winner differs
  mask_mismatch share of all pixels whose coverage differs
  image_gap     largest |program - reference| of the image where both
                pick the same winner
Frame cells get back only coefficients, landmarks and image: coef_gap,
lmk_gap_px and image_mismatch (share of pixels off by more than 0.01).

Training cells (`judge_train`): the program's first three steps from the
benchmark's leaves against the reference's three steps on the same
batches:
  loss_gap    worst step's total loss: |program - reference| over
              |reference|
  coef_gap    the coefficients the CNN regressed in the first step (train
              mode, the same leaves), as coef_gap above (the rows both
              sides hold)
  grad_gap    the median leaf's | |g_program| - |g_ref| | of the first
              step's gradient over max(|g_ref|, the median leaf's |g_ref|)
              (the worst leaf is a 64-value BatchNorm leaf whose gap is
              noise, see PERF.md)
  change_gap  the same of the leaves' change after three steps, over
              the leaves whose reference gradient is at least a
              thousandth of the median leaf's; of the faults it
              catches only a state left unchanged
"""

from __future__ import annotations

import statistics

import torch

from perfbench import frozen, reference
from perfbench.reference import cnn, pipeline as ref

BLOCK = 16


def _coef_gap(prog, refc, sizes):
    spread = frozen.coeff_spread(sizes)
    worst = 0.0
    for g, sl in frozen.group_slices(sizes).items():
        rms = ((prog[:, sl] - refc[:, sl]) ** 2).mean(1).sqrt()
        worst = max(worst, float(rms.max()) / spread[g][1])
    return worst


def reference_coeffs(leaves, images):
    """The reference's eval-mode coefficients, in blocks of images."""
    with torch.no_grad():
        return torch.cat([cnn.regress(leaves, images[i:i + BLOCK], False)
                          for i in range(0, images.shape[0], BLOCK)])


@torch.no_grad()
def judge_render(prog: dict, mesh, cam, sizes, leaves=None, images=None,
                 background=None) -> dict:
    """prog: the program's 'coeff' (B, n_coeff) and, where it returns
    them, 'verts' (B, N, 3), 'landmarks' (B, 68, 2), 'image' (B, H, W, 3),
    'tri_id' (B, H, W). images/leaves: the CNN's inputs, where it ran."""
    reference.strict()
    dev = prog["coeff"].device
    out = {}
    if images is not None:
        out["coef_gap"] = _coef_gap(prog["coeff"], reference_coeffs(
            leaves, images.to(dev)), sizes)
    vert = lmk = tri_diff = tri_any = mask_diff = 0
    img_gap = 0.0
    img_off = px = 0
    for i in range(0, prog["coeff"].shape[0], BLOCK):
        sl = slice(i, i + BLOCK)
        bg = None if background is None else background[sl].to(dev)
        r = ref.render(prog["coeff"][sl], mesh, cam, sizes, background=bg)
        if "verts" in prog:
            vert = max(vert, float((prog["verts"][sl].to(dev)
                                    - r.geometry.verts).abs().max()))
        lmk = max(lmk, float((prog["landmarks"][sl].to(dev)
                              - r.geometry.landmarks).abs().max()))
        image = prog["image"][sl].to(dev)
        px += r.mask.numel()
        if "tri_id" in prog:
            t = prog["tri_id"][sl].to(dev).to(torch.int64)
            either = (t >= 0) | (r.tri_id >= 0)
            tri_any += int(either.sum())
            tri_diff += int(((t != r.tri_id) & either).sum())
            mask_diff += int(((t >= 0) != (r.tri_id >= 0)).sum())
            same = (t == r.tri_id) & (t >= 0)
            if bool(same.any()):
                img_gap = max(img_gap, float((image - r.image).abs()
                                             .amax(-1)[same].max()))
        else:
            img_off += int(((image - r.image).abs().amax(-1) > 0.01).sum())
    if "verts" in prog:
        out["vert_gap"] = vert
    out["lmk_gap_px"] = lmk
    if "tri_id" in prog:
        out["tri_mismatch"] = tri_diff / max(tri_any, 1)
        out["mask_mismatch"] = mask_diff / max(px, 1)
        out["image_gap"] = img_gap
    else:
        out["image_mismatch"] = img_off / max(px, 1)
    return out


def leaf_gaps(prog: dict, refn: dict, keep=None) -> dict:
    """leaf -> | |program| - |reference| | over max(|reference|, the
    median leaf's |reference|)."""
    keys = [k for k in refn if keep is None or k in keep]
    med = statistics.median(refn[k] for k in keys)
    return {k: abs(prog.get(k, 0.0) - refn[k]) / max(refn[k], med, 1e-30)
            for k in keys}


def kept_leaves(refr) -> set:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's (the others move under Adam by rounding alone)."""
    med = statistics.median(refr.grad_norms.values())
    return {k for k, v in refr.grad_norms.items() if v >= 1e-3 * med}


def judge_train(prog, refr, sizes) -> dict:
    """prog and refr: reference.pipeline.TrainReadings of each side."""
    reference.strict()
    loss = max(abs(p["total"] - r["total"]) / abs(r["total"])
               for p, r in zip(prog.losses, refr.losses))
    rows = min(prog.coeff.shape[0], refr.coeff.shape[0])
    grad = leaf_gaps(prog.grad_norms, refr.grad_norms)
    change = leaf_gaps(prog.change_norms, refr.change_norms,
                       kept_leaves(refr))
    return {"loss_gap": loss,
            "coef_gap": _coef_gap(prog.coeff[:rows].to(refr.coeff.device),
                                  refr.coeff[:rows], sizes),
            "grad_gap": statistics.median(grad.values()),
            "change_gap": statistics.median(change.values())}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number that is not finite fails."""
    compared = {k: {"value": v, "limit": limits.get(k)}
                for k, v in numbers.items()}
    ok = all(k in limits and v == v and v <= limits[k]
             for k, v in numbers.items())
    return ok and set(numbers) == set(limits), compared
