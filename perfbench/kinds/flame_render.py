"""flame_render: DECA's coarse model on FLAME through the program's
ops/render.render_coeffs(inference=True) over resident DECA codes in
microbatches, no CNN; a unit is one pass over the batch.

The codes (`sample_codes`) are drawn from the seed: shape, expression
and albedo N(0, 1) per component; the global rotation an axis-angle
(pitch, yaw, roll) with yaw U(-60, 60) degrees (both clamp branches of
the contour table), pitch U(-20, 20), roll U(-15, 15); the jaw about x
U(0, 0.35) rad; the orthographic scale U(8, 10) and the translation
U(-0.03, 0.03); the light's DC term per channel U(2.5, 3.9), its other 24
values N(0, 0.3). FLAME's and the albedo's arrays are the seeded
stand-ins of flame_data.py (the configuration's `mesh_seed`).

`judge` holds what the last unit produced against reference/deca.py,
computed in blocks:
  vert_gap          largest |program - reference| of a posed vertex
                    (world, m)
  lmk_bin_mismatch  share of the faces whose contour-table row differs
  lmk_gap_px        largest |program - reference| of a landmark (pixels)
                    over the faces whose rows agree
  tri_mismatch      share of the pixels either covers whose winner
                    differs
  mask_mismatch     share of all pixels whose coverage differs
  image_gap         largest |program - reference| of the image where
                    both pick the same winner
`FAULTS` plants a program fault after set-up: `no_correctives` (FLAME's
pose correctives dropped) and `nearest_fetch` (the albedo read at the
nearest texel, through the plain version of the textured raster)."""

from __future__ import annotations

import dataclasses
import json
import math
import time

import numpy as np
import torch

from perfbench import flame_data, reference
from perfbench.kinds import sync
from perfbench.reference import deca

BLOCK = 16
_ARRAYS: dict = {}


def arrays(cfgf: dict) -> dict:
    """The configuration's FLAME stand-ins (made once a process: they do
    not depend on the run's seed)."""
    key = json.dumps([cfgf["sizes"], cfgf["flame"], cfgf["mesh"],
                      cfgf["mesh_seed"]], sort_keys=True)
    if key not in _ARRAYS:
        sizes = dict(cfgf["sizes"], albedo_size=cfgf["flame"]["albedo_size"])
        _ARRAYS[key] = flame_data.flame_arrays(sizes, cfgf["mesh"],
                                               cfgf["mesh_seed"])
    return _ARRAYS[key]


def sample_codes(rng: np.random.Generator, sizes: dict,
                 batch: int) -> np.ndarray:
    """(B, 236) DECA codes, as the module's docstring draws them."""
    deg = math.pi / 180.0
    parts = {k: rng.standard_normal((batch, sizes[f"n_{k}"]))
             for k in ("shape", "tex", "exp")}
    pitch = rng.uniform(-20, 20, batch) * deg
    yaw = rng.uniform(-60, 60, batch) * deg
    roll = rng.uniform(-15, 15, batch) * deg
    jaw = rng.uniform(0.0, 0.35, batch)
    z = np.zeros(batch)
    parts["pose"] = np.stack([pitch, yaw, roll, jaw, z, z], 1)
    parts["cam"] = np.stack([rng.uniform(8.0, 10.0, batch),
                             rng.uniform(-0.03, 0.03, batch),
                             rng.uniform(-0.03, 0.03, batch)], 1)
    light = rng.normal(0.0, 0.3, (batch, 9, 3))
    light[:, 0, :] = rng.uniform(2.5, 3.9, (batch, 3))
    parts["light"] = light.reshape(batch, 27)
    return np.concatenate([parts[k] for k, _ in deca.SIZES], 1).astype(
        np.float32)


FIXED = ("n_pose", "n_cam", "n_light")


def port_config(cfgf: dict, batch: int):
    """The program's config for the configuration file; the pose, cam and
    light groups have one layout in the program (config.DECA_FIXED)."""
    from facerecon_tpu_torch.config import DECA_FIXED, FaceReconConfig
    sizes = dict(cfgf["sizes"])
    fixed = tuple(sizes.pop(k) for k in FIXED)
    if fixed != DECA_FIXED:
        raise ValueError(f"{dict(zip(FIXED, fixed))}: the program has "
                         f"DECA's {dict(zip(FIXED, DECA_FIXED))} only")
    return FaceReconConfig(model="flame", batch_size=batch,
                           image_size=cfgf["camera"]["image_size"],
                           **sizes, **cfgf["raster"])


def port_flame(arr: dict, cfg, dev):
    """The program's asset pack from the benchmark's arrays; the program
    derives its own adjacency and raster row order."""
    from facerecon_tpu_torch.ops.flame import device_flame
    from facerecon_tpu_torch.utils.flame import flame_assets
    return device_flame(flame_assets(arr, cfg.image_size), dev, cfg.n_tex,
                        cfg.uv_size)


class Kind:

    cnn = False
    unit_faces = 1

    def __init__(self, spec: dict, seed: int, dev: torch.device):
        self.seed, self.dev = int(seed) % (1 << 64), dev
        reference.strict()
        t = time.perf_counter()
        self.cfgf = spec["config_file"]
        self.tr = spec["traffic"]
        self.sizes = self.cfgf["sizes"]
        self.size = self.cfgf["camera"]["image_size"]
        self.uv_size = self.sizes["uv_size"]
        self.arrays = arrays(self.cfgf)
        self.phases = {"mesh": time.perf_counter() - t}
        t = time.perf_counter()
        self.fl = deca.flame_on(self.arrays, dev)
        self.n_vertices = self.fl.v_template.shape[0]
        self.captured = []
        sync(dev)
        self.phases["leaves"] = time.perf_counter() - t

    def setup(self):
        tr = self.tr
        self.batch, self.micro = tr["batch"], tr["microbatch"]
        self.cfg = port_config(self.cfgf, self.batch)
        self.flame = port_flame(self.arrays, self.cfg, self.dev)
        self.codes = torch.from_numpy(sample_codes(
            np.random.default_rng(self.seed), self.sizes, self.batch)).to(
                self.dev)
        self.unit_faces = self.batch
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)

    def warm(self):
        """One unit at the cell's shapes (the first run in a checkout
        builds the kernels here)."""
        self.step()
        sync(self.dev)

    def step(self):
        from facerecon_tpu_torch.ops.render import render_coeffs
        from facerecon_tpu_torch.utils.coeffs import split_coeff
        outs = []
        with torch.no_grad():
            for c in self.codes.split(self.micro):
                outs.append((c, render_coeffs(split_coeff(c, self.cfg),
                                              self.flame, self.cfg,
                                              inference=True)))
        self.last = outs

    def traced(self):
        self.captured.extend(self.codes.split(self.micro))
        return []

    def outputs(self) -> dict:
        def cat(get):
            return torch.cat([get(c, o) for c, o in self.last])
        return {"codes": cat(lambda c, o: c),
                "verts": cat(lambda c, o: o.geometry.verts_world),
                "landmarks": cat(lambda c, o: o.geometry.landmarks2d),
                "bins": cat(lambda c, o: o.geometry.contour_bin),
                "image": cat(lambda c, o: o.image),
                "tri_id": cat(lambda c, o: o.tri_id)}

    def free(self):
        self.flame = self.last = None

    def judge(self, prog: dict) -> dict:
        return judge(prog, self.fl, self.size, self.uv_size)

    @torch.no_grad()
    def control(self) -> dict:
        """The reference in the program's place, one precision below the
        configuration's (every matrix product in TF32)."""
        outs = [deca.render(c, self.fl, self.size, self.uv_size, "tf32")
                for c in self.codes.split(BLOCK)]
        return {"codes": self.codes,
                "verts": torch.cat([o.verts for o in outs]),
                "landmarks": torch.cat([o.landmarks for o in outs]),
                "bins": torch.cat([o.bins for o in outs]),
                "image": torch.cat([o.image for o in outs]),
                "tri_id": torch.cat([o.tri_id for o in outs])}


@torch.no_grad()
def judge(prog: dict, fl, size: int, uv_size: int) -> dict:
    """The module docstring's numbers: prog holds the program's 'codes'
    (B, 236), 'verts', 'landmarks', 'bins', 'image' and 'tri_id'; fl the
    reference's reference.deca.Flame."""
    reference.strict()
    dev = prog["codes"].device
    vert = lmk = img_gap = 0.0
    bin_diff = tri_diff = tri_any = mask_diff = px = 0
    n = prog["codes"].shape[0]
    for i in range(0, n, BLOCK):
        sl = slice(i, i + BLOCK)
        r = deca.render(prog["codes"][sl], fl, size, uv_size)
        vert = max(vert, float((prog["verts"][sl].to(dev)
                                - r.verts).abs().max()))
        agree = prog["bins"][sl].to(dev) == r.bins
        bin_diff += int((~agree).sum())
        if bool(agree.any()):
            lmk = max(lmk, float((prog["landmarks"][sl].to(dev)
                                  - r.landmarks)[agree].abs().max()))
        t = prog["tri_id"][sl].to(dev).to(torch.int64)
        either = (t >= 0) | (r.tri_id >= 0)
        tri_any += int(either.sum())
        tri_diff += int(((t != r.tri_id) & either).sum())
        mask_diff += int(((t >= 0) != (r.tri_id >= 0)).sum())
        px += t.numel()
        same = (t == r.tri_id) & (t >= 0)
        if bool(same.any()):
            img_gap = max(img_gap, float(
                (prog["image"][sl].to(dev) - r.image).abs().amax(-1)[
                    same].max()))
    return {"vert_gap": vert, "lmk_bin_mismatch": bin_diff / max(n, 1),
            "lmk_gap_px": lmk, "tri_mismatch": tri_diff / max(tri_any, 1),
            "mask_mismatch": mask_diff / max(px, 1), "image_gap": img_gap}


# --- faults planted under the timed path (the tests, and limit readings
# on the card) ---

def no_correctives(kind):
    """FLAME without its pose correctives: posedirs zeroed."""
    kind.flame = dataclasses.replace(
        kind.flame, posedirs=torch.zeros_like(kind.flame.posedirs))


def nearest_fetch(kind):
    """The albedo read at the nearest texel in place of the bilinear
    fetch: the textured raster through its plain version, whose fetch
    takes the nearest of the four corners."""
    import facerecon_tpu_torch.ops.rasterize as R

    def nearest(tex, gx, gy):
        size = tex.shape[0]
        ix = torch.round(((gx + 1.0) * size - 1.0) / 2.0)
        iy = torch.round(((gy + 1.0) * size - 1.0) / 2.0)
        inb = (ix >= 0) & (ix < size) & (iy >= 0) & (iy < size)
        at = (iy.clamp(0, size - 1) * size + ix.clamp(0, size - 1)).long()
        return torch.where(inb[:, None], tex.reshape(size * size, -1)[at],
                           0.0)
    real = R.bilinear_zeros
    plain = R.texture_windows_reference

    def texture_windows(*a, **k):
        R.bilinear_zeros = nearest
        try:
            return plain(*a, **k)
        finally:
            R.bilinear_zeros = real
    R.texture_windows = texture_windows


FAULTS = {"no_correctives": no_correctives, "nearest_fetch": nearest_fetch}
