"""flame_detail: DECA's detail model on FLAME through the program's
ops/render.render_coeffs(inference=True) over resident DECA codes in
microbatches, no CNN; a unit is one pass over the batch. The render is
the detailed image: FLAME, the albedo, the detail decoder, the UV detail
pass, the records, the binning and the fetch of the shaded UV texture.

The codes are flame_render.sample_codes' 236, then the detail code
N(0, 1) per component (`sample_codes`; E_d's output distribution is not
published). FLAME's and the albedo's arrays are flame_render's stand-ins,
the detail arrays detail_data.detail_arrays' (both from the
configuration's `mesh_seed`), and the decoder's weights
detail_data.decoder_state's from the run's seed, calibrated on
CALIB_BATCH code sets drawn from [seed, 1].

`judge` holds what the last unit produced against
reference/deca_detail.py, computed in blocks: flame_render's vert_gap,
lmk_bin_mismatch, lmk_gap_px, tri_mismatch and mask_mismatch, and
  image_gap    largest |program - reference| of the detailed image where
               both pick the same winner
  disp_gap     RMS of the displacement map's gap over the mask's texels
               over the RMS of the reference's uv_z there
  normal_gap   largest angle (rad) between the detail normals and the
               reference's on the mask's texels, leaving out each texel
               whose UV face, or a neighbour's, differs between the
               program's static table and the reference's world2uv, and
               each texel where the displaced surface (nearly) folds:
               the reference's dense normal before normalisation shorter
               than FOLD x its image's median over the mask. There the
               normal is a difference of nearly equal cross products,
               which rounding alone turns: on the card, over 36 seeds,
               the TF32 decoder's largest angle was 0.37 rad with no
               texel left out, 0.10 with those under 0.015 of the
               median, 0.053 under 0.03 and 0.023 under FOLD, which
               leaves out at most 7.8e-4 of the mask's texels
               (PERF.md section 2)
  normal_skipped  share of the mask's texels, over the judged images,
               that normal_gap leaves out by either rule, so that a run
               whose comparison of normals leaves out much is seen
`FAULTS` plants a program fault after set-up: `no_uv_z` (the decoder's
output dropped), `no_mask` (the mask not applied), `bn_eps` (the
BatchNorms' eps 1e-5 in place of 0.8) and `coarse_normals` (the coarse
normals in place of the dense grid's). `control` is the reference with
the decoder's convolutions in bfloat16."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import detail_data, reference
from perfbench.kinds import flame_render as FR
from perfbench.kinds import sync
from perfbench.reference import deca_detail

BLOCK = 16
CALIB_BATCH = 32
FOLD = 0.1
_ARRAYS: dict = {}


def arrays(cfgf: dict) -> dict:
    """FLAME's stand-ins and the detail arrays (made once a process)."""
    key = json.dumps([cfgf["sizes"], cfgf["flame"], cfgf["mesh"],
                      cfgf["mesh_seed"]], sort_keys=True)
    if key not in _ARRAYS:
        base = FR.arrays(cfgf)
        _ARRAYS[key] = dict(base, **detail_data.detail_arrays(
            base, cfgf["sizes"]["uv_size"], cfgf["mesh_seed"]))
    return _ARRAYS[key]


def sample_codes(rng: np.random.Generator, sizes: dict,
                 batch: int) -> np.ndarray:
    """(B, 236 + n_detail): flame_render's codes, then the detail code."""
    coarse = FR.sample_codes(rng, sizes, batch)
    detail = rng.standard_normal((batch, sizes["n_detail"]))
    return np.concatenate([coarse, detail], 1).astype(np.float32)


def decoder_inputs(codes) -> torch.Tensor:
    """DECA's [jaw | exp | detail] from codes (B, 236 + n_detail)."""
    c = deca_detail.deca.split(codes[:, :deca_detail.COARSE])
    return torch.cat([c["pose"][:, 3:], c["exp"],
                      codes[:, deca_detail.COARSE:]], 1)


class Kind(FR.Kind):

    def __init__(self, spec: dict, seed: int, dev: torch.device):
        super().__init__(spec, seed, dev)
        self.arrays = arrays(self.cfgf)
        dec = self.cfgf["decoder"]
        if (tuple(dec["channels"]), dec["eps"], dec["slope"],
                dec["max_z"]) != (deca_detail.CHANNELS, [1e-5, 0.8], 0.2,
                                  0.01):
            raise ValueError(f"{dec}: the reference has DECA's decoder only")
        self.latent = 3 + self.sizes["n_exp"] + self.sizes["n_detail"]
        calib = torch.from_numpy(sample_codes(
            np.random.default_rng([self.seed, 1]), self.sizes,
            CALIB_BATCH)).to(dev)
        self.state = detail_data.decoder_state(
            self.seed, self.latent, self.uv_size, decoder_inputs(calib), dev)
        self.det = deca_detail.detail_on(
            self.state, self.arrays["fixed_uv_dis"],
            self.arrays["uv_face_eye_mask"], self.latent, dev)
        sync(dev)

    def setup(self):
        from facerecon_tpu_torch.models.deca_detail import DetailGenerator
        from facerecon_tpu_torch.ops.flame import device_flame
        from facerecon_tpu_torch.utils.flame import flame_assets
        tr = self.tr
        self.batch, self.micro = tr["batch"], tr["microbatch"]
        self.cfg = FR.port_config(self.cfgf, self.batch)
        gen = DetailGenerator(self.latent, self.uv_size)
        gen.load_state_dict(self.state)
        self.flame = device_flame(flame_assets(self.arrays, self.size),
                                  self.dev, self.cfg.n_tex, self.cfg.uv_size,
                                  decoder=gen.to(self.dev))
        self.codes = torch.from_numpy(sample_codes(
            np.random.default_rng(self.seed), self.sizes, self.batch)).to(
                self.dev)
        self.unit_faces = self.batch
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)

    def outputs(self) -> dict:
        out = super().outputs()

        def cat(get):
            return torch.cat([get(o) for _, o in self.last])
        out.update(disp=cat(lambda o: o.displacement_map),
                   normals=cat(lambda o: o.uv_detail_normals),
                   texel_face=self.flame.detail.texel_face)
        return out

    def judge(self, prog: dict) -> dict:
        return judge(prog, self.fl, self.det, self.size)

    @torch.no_grad()
    def control(self) -> dict:
        """The reference in the program's place with the decoder's
        convolutions in bfloat16."""
        outs = [deca_detail.render(c, self.fl, self.det, self.size, "bf16")
                for c in self.codes.split(BLOCK)]

        def cat(get):
            return torch.cat([get(o) for o in outs])
        face, _ = deca_detail.uv_rasterize(self.fl, self.uv_size)
        return {"codes": self.codes, "verts": cat(lambda o: o.coarse.verts),
                "landmarks": cat(lambda o: o.coarse.landmarks),
                "bins": cat(lambda o: o.coarse.bins),
                "image": cat(lambda o: o.image),
                "tri_id": cat(lambda o: o.coarse.tri_id),
                "disp": cat(lambda o: o.displacement),
                "normals": cat(lambda o: o.normals), "texel_face": face}


def _angle(a, b):
    """Angle (rad) between the vectors of a and b (..., 3)."""
    cross = torch.linalg.vector_norm(torch.linalg.cross(a, b, dim=-1),
                                     dim=-1)
    return torch.atan2(cross, (a * b).sum(-1))


@torch.no_grad()
def judge(prog: dict, fl, det, size: int) -> dict:
    """The module docstring's numbers: prog holds flame_render's keys
    and 'disp' (B, S, S), 'normals' (B, S, S, 3) and 'texel_face' (S^2,)
    the program's UV table; det the reference's deca_detail.Detail."""
    reference.strict()
    dev = prog["codes"].device
    s = det.fixed_uv_dis.shape[0]
    face, _ = deca_detail.uv_rasterize(fl, s)
    differs = (prog["texel_face"].to(dev).to(torch.int64) != face).view(
        1, 1, s, s).to(torch.float32)
    near = F.max_pool2d(differs, 3, 1, 1).view(s, s) > 0
    m = det.uv_face_eye_mask > 0
    judged = m & ~near
    vert = lmk = img_gap = normal = 0.0
    bin_diff = tri_diff = tri_any = mask_diff = px = skipped = judged_of = 0
    gap2 = z2 = 0.0
    n = prog["codes"].shape[0]
    for i in range(0, n, BLOCK):
        sl = slice(i, i + BLOCK)
        r = deca_detail.render(prog["codes"][sl], fl, det, size)
        c = r.coarse
        vert = max(vert, float((prog["verts"][sl].to(dev)
                                - c.verts).abs().max()))
        agree = prog["bins"][sl].to(dev) == c.bins
        bin_diff += int((~agree).sum())
        if bool(agree.any()):
            lmk = max(lmk, float((prog["landmarks"][sl].to(dev)
                                  - c.landmarks)[agree].abs().max()))
        t = prog["tri_id"][sl].to(dev).to(torch.int64)
        either = (t >= 0) | (c.tri_id >= 0)
        tri_any += int(either.sum())
        tri_diff += int(((t != c.tri_id) & either).sum())
        mask_diff += int(((t >= 0) != (c.tri_id >= 0)).sum())
        px += t.numel()
        same = (t == c.tri_id) & (t >= 0)
        if bool(same.any()):
            img_gap = max(img_gap, float(
                (prog["image"][sl].to(dev) - r.image).abs().amax(-1)[
                    same].max()))
        d = prog["disp"][sl].to(dev) - r.displacement
        gap2 += float((d[:, m] ** 2).sum())
        z2 += float((r.uv_z[:, m] ** 2).sum())
        ln = r.normal_length
        med = ln[:, m].median(dim=1).values[:, None, None]
        keep = judged & (ln >= FOLD * med)
        skipped += int((m & ~keep).sum())
        judged_of += int(m.sum()) * ln.shape[0]
        if bool(keep.any()):
            normal = max(normal, float(_angle(
                prog["normals"][sl].to(dev)[keep], r.normals[keep]).max()))
    return {"vert_gap": vert, "lmk_bin_mismatch": bin_diff / max(n, 1),
            "lmk_gap_px": lmk, "tri_mismatch": tri_diff / max(tri_any, 1),
            "mask_mismatch": mask_diff / max(px, 1), "image_gap": img_gap,
            "disp_gap": (gap2 / max(z2, 1e-30)) ** 0.5,
            "normal_gap": normal,
            "normal_skipped": skipped / max(judged_of, 1)}


# --- faults planted under the timed path (the tests, and limit readings
# on the card) ---

def _with_detail(kind, **changes):
    kind.flame = dataclasses.replace(kind.flame, detail=dataclasses.replace(
        kind.flame.detail, **changes))


class _Zeros(torch.nn.Module):
    def __init__(self, size):
        super().__init__()
        self.size = size

    def forward(self, z):
        return z.new_zeros((z.shape[0], 1, self.size, self.size))


def no_uv_z(kind):
    """The decoder's displacement dropped: uv_z = 0."""
    _with_detail(kind, decoder=_Zeros(kind.uv_size))


def no_mask(kind):
    """The mask not applied: M = 1 on every texel."""
    _with_detail(kind, eye_mask=torch.ones_like(kind.flame.detail.eye_mask))


def coarse_normals(kind):
    """The coarse normals in place of the dense grid's: with M = 0 the
    kernel blends in the coarse normals on every texel (and displaces
    nothing but the fixed field, which the judged displacement map does
    not see)."""
    _with_detail(kind, eye_mask=torch.zeros_like(kind.flame.detail.eye_mask))


def bn_eps(kind):
    """The decoder folded with eps 1e-5 on every BatchNorm in place of
    0.8 after the first."""
    from facerecon_tpu_torch.models.deca_detail import (DetailGenerator,
                                                        FusedDetailGenerator)
    gen = DetailGenerator(kind.latent, kind.uv_size)
    gen.load_state_dict(kind.state)
    for m in gen.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eps = 1e-5
    _with_detail(kind, decoder=FusedDetailGenerator.fold(
        gen.to(kind.dev).eval()))


FAULTS = {"no_uv_z": no_uv_z, "no_mask": no_mask, "bn_eps": bn_eps,
          "coarse_normals": coarse_normals}
