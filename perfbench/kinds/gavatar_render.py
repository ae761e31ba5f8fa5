"""gavatar_render: GaussianAvatars through the program's
ops/render.render_coeffs(inference=True) over resident frame codes in
microbatches, no CNN; a unit is one pass over the batch.

The frames (`sample_codes`) are drawn from the seed: one identity (the
shape code N(0, 1) a component, drawn first, shared by every frame);
per frame the expression N(0, 1) a component, the global rotation and
the jaw as flame_render.sample_codes draws them (an axis-angle (pitch,
yaw, roll) with pitch U(-20, 20), yaw U(-60, 60), roll U(-15, 15)
degrees; the jaw U(0, 0.35) rad about x), the neck and both eyes N(0,
0.1) rad about each axis, no translation, and one of the rig's cameras,
uniform and independent a frame. FLAME's arrays, the Gaussians and the
rig are avatar_data.py's stand-ins (the configuration's seeds).

`judge` holds what the last unit produced against
reference/gaussian_avatar.py, computed in blocks, each stage on what the
program handed it (as check.py judges a render on the program's
coefficients): FLAME from the codes, then the binding and the splat from
the program's posed vertices:
  vert_gap       largest |program - reference| of a posed FLAME vertex
                 (m)
  mean_gap       largest |program - reference| of a Gaussian's world
                 mean (m)
  rect_mismatch  share of the (frame, Gaussian) whose tile rectangle
                 (from the program's pixel and radius) differs
  image_gap      largest |program - reference| of the image, over the
                 pixels the judge keeps: not in a tile of a Gaussian whose
                 rectangle differs, and not `unsure` in the reference (a
                 decision of its blend that rounding can flip: two
                 Gaussians it takes in turn within EPS_DEPTH m of depth, an
                 alpha within 5e-3 (relative) of 1/255, or a transmittance
                 within its compounded uncertainty of 1e-4, each where the
                 flip would move the pixel by more than 1e-4)
  alpha_gap      the same of the alpha (1 - T)
  image_skipped  share of the pixels those two leave out
`FAULTS` plants a program fault after set-up: `no_sort` (the blend in
Gaussian-id order), `near_ties` (Gaussians within ~1e-6 m of depth in id
order), `no_dilation` (no 0.3 on the 2D diagonal), `sh0` (the colour of
SH degree 0 only) and `unit_scale` (the binding's scale k taken as 1);
each goes away when the kind is freed. `control` is the
reference with the 2D conic, alpha and the blend in float16."""

from __future__ import annotations

import dataclasses
import json
import math
import time

import numpy as np
import torch

from perfbench import avatar_data, reference
from perfbench.kinds import sync
from perfbench.reference import gaussian_avatar as ga

BLOCK = 16
_ARRAYS: dict = {}


def arrays(cfgf: dict) -> dict:
    """The configuration's stand-ins (made once a process: they do not
    depend on the run's seed)."""
    key = json.dumps([cfgf["sizes"], cfgf["mesh"], cfgf["mesh_seed"],
                      cfgf["avatar_seed"], cfgf["stand_ins"]],
                     sort_keys=True)
    if key not in _ARRAYS:
        _ARRAYS[key] = avatar_data.avatar_arrays(cfgf)
    return _ARRAYS[key]


def sample_codes(rng: np.random.Generator, sizes: dict, cams: np.ndarray,
                 batch: int) -> np.ndarray:
    """(B, 432) frame codes, as the module's docstring draws them."""
    deg = math.pi / 180.0
    shape = np.broadcast_to(rng.standard_normal(sizes["n_shape"]),
                            (batch, sizes["n_shape"]))
    exp = rng.standard_normal((batch, sizes["n_exp"]))
    pitch = rng.uniform(-20, 20, batch) * deg
    yaw = rng.uniform(-60, 60, batch) * deg
    roll = rng.uniform(-15, 15, batch) * deg
    jaw = rng.uniform(0.0, 0.35, batch)
    neck = rng.normal(0.0, 0.1, (batch, 3))
    eyes = rng.normal(0.0, 0.1, (batch, 6))
    z = np.zeros(batch)
    pose = np.concatenate([np.stack([pitch, yaw, roll], 1), neck,
                           np.stack([jaw, z, z], 1), eyes], 1)
    cam = cams[rng.integers(len(cams), size=batch)]
    return np.concatenate([shape, exp, pose, np.zeros((batch, 3)), cam],
                          1).astype(np.float32)


def port_config(cfgf: dict, batch: int):
    """The program's config for the configuration file; the pose and the
    translation have one layout in the program (config.AVATAR_FIXED)."""
    from facerecon_tpu_torch.config import AVATAR_FIXED, gavatar_config
    s, cam = cfgf["sizes"], cfgf["camera"]
    if (s["n_pose"], s["n_trans"], s["sh_degree"]) != (*AVATAR_FIXED[:2],
                                                        3):
        raise ValueError(f"the program has a pose of {AVATAR_FIXED[0]}, a "
                         f"translation of {AVATAR_FIXED[1]} and SH degree 3 "
                         f"only")
    return gavatar_config(
        batch_size=batch, n_shape=s["n_shape"], n_exp=s["n_exp"],
        n_vertices=s["n_vertices"], n_faces=s["n_faces"],
        image_height=cam["image_height"], image_width=cam["image_width"])


def port_avatar(arr: dict, dev):
    """The program's asset pack from the benchmark's arrays."""
    from facerecon_tpu_torch.ops.gavatar import device_avatar
    from facerecon_tpu_torch.utils.gavatar import avatar_assets
    return device_avatar(avatar_assets(arr), dev)


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
        cam = self.cfgf["camera"]
        self.hw = (cam["image_height"], cam["image_width"])
        self.background = tuple(self.cfgf["splat"]["background"])
        self.arrays = arrays(self.cfgf)
        self.cams = avatar_data.camera_rig(cam)
        self.phases = {"mesh": time.perf_counter() - t}
        t = time.perf_counter()
        self.av = ga.avatar_on(self.arrays, dev)
        self.n_vertices = self.av.v_template.shape[0]
        self.captured = []
        self.undo = []
        sync(dev)
        self.phases["leaves"] = time.perf_counter() - t

    def setup(self):
        tr = self.tr
        self.batch, self.micro = tr["batch"], tr["microbatch"]
        self.cfg = port_config(self.cfgf, self.batch)
        self.avatar = port_avatar(self.arrays, self.dev)
        self.codes = torch.from_numpy(sample_codes(
            np.random.default_rng(self.seed), self.sizes, self.cams,
            self.batch)).to(self.dev)
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
                outs.append((c, render_coeffs(
                    split_coeff(c, self.cfg), self.avatar, self.cfg,
                    background=self.background, inference=True)))
        self.last = outs

    def traced(self):
        self.captured.extend(self.codes.split(self.micro))
        return []

    def pairs_per_frame(self):
        """Gaussian-tile pairs a frame of the last unit (the traced one
        after the stretch), from the host's count each microbatch's
        render keeps in its geometry."""
        return (sum(o.geometry.pairs for _, o in self.last)
                / sum(c.shape[0] for c, _ in self.last))

    def outputs(self) -> dict:
        def cat(get):
            return torch.cat([get(c, o) for c, o in self.last])
        return {"codes": cat(lambda c, o: c),
                "verts": cat(lambda c, o: o.geometry.verts_world),
                "means": cat(lambda c, o: o.geometry.means),
                "xy": cat(lambda c, o: o.geometry.xy),
                "radius": cat(lambda c, o: o.geometry.radius),
                "image": cat(lambda c, o: o.image),
                "alpha": cat(lambda c, o: o.mask)}

    def free(self):
        self.avatar = self.last = None
        while self.undo:
            self.undo.pop()()

    def judge(self, prog: dict) -> dict:
        return judge(prog, self.av, self.hw, self.background)

    @torch.no_grad()
    def control(self) -> dict:
        """The reference in the program's place, one precision below the
        configuration's (the 2D conic, alpha and the blend in float16)."""
        parts = {k: [] for k in ("verts", "means", "xy", "radius", "image",
                                 "alpha")}
        for _, r in ga.render_blocks(self.codes, self.av, *self.hw,
                                     self.background, precision="f16"):
            for k in parts:
                parts[k].append(getattr(r, k))
        return dict({k: torch.cat(v) for k, v in parts.items()},
                    codes=self.codes)


def _tiles_of(rects, frame, bsz: int, tiles_x: int, tiles_y: int, dev):
    """(bsz, tiles_y, tiles_x) bool: the tiles any of the rectangles (4 of
    (M,), [x0, x1) x [y0, y1)) of frames `frame` (M,) covers, by a
    difference array and its 2D prefix sum."""
    x0, y0, x1, y1 = rects
    grid = torch.zeros((bsz, tiles_y + 1, tiles_x + 1), dtype=torch.int64,
                       device=dev)
    live = (x1 > x0) & (y1 > y0)
    f = frame[live]
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        grid.index_put_((f, ys[live], xs[live]),
                        torch.full_like(f, sign), accumulate=True)
    return grid.cumsum(1).cumsum(2)[:, :tiles_y, :tiles_x] > 0


@torch.no_grad()
def judge(prog: dict, av, hw, background, **ref_kw) -> dict:
    """The module docstring's numbers: prog holds the program's 'codes'
    (B, 432), 'verts', 'means', 'xy', 'radius', 'image' and 'alpha'; av
    the reference's reference.gaussian_avatar.Avatar."""
    reference.strict()
    height, width = hw
    tiles_x, tiles_y = (width + ga.TILE - 1) // ga.TILE, \
        (height + ga.TILE - 1) // ga.TILE
    dev = prog["codes"].device
    vert = mean = img = alp = 0.0
    rect_diff = n_gauss = skipped = px = 0
    for sl, r in ga.render_blocks(prog["codes"], av, height, width,
                                  background, block=BLOCK,
                                  verts=prog["verts"].to(dev), **ref_kw):
        bsz, g = r.radius.shape
        c = ga.split(prog["codes"][sl])
        vert = max(vert, float((r.verts - ga.flame(
            c["shape"], c["exp"], c["pose"], c["trans"], av)).abs().max()))
        mean = max(mean, float((prog["means"][sl].to(dev)
                                - r.means).abs().max()))
        rad = prog["radius"][sl].to(dev).to(torch.int64)
        mine = ga.tile_rect(prog["xy"][sl].to(dev), rad, tiles_x, tiles_y)
        mine = tuple(torch.where(rad > 0, v, 0) for v in mine)
        diff = torch.zeros_like(rad, dtype=torch.bool)
        for a, b in zip(mine, r.rect):
            diff |= a != b
        rect_diff += int(diff.sum())
        n_gauss += diff.numel()
        at = torch.nonzero(diff.reshape(-1)).squeeze(1)
        frame = at // g
        bad = torch.zeros((bsz, tiles_y, tiles_x), dtype=torch.bool,
                          device=dev)
        for rect in (mine, r.rect):
            bad |= _tiles_of(tuple(v.reshape(-1)[at] for v in rect), frame,
                             bsz, tiles_x, tiles_y, dev)
        bad = bad.view(bsz, tiles_y, 1, tiles_x, 1).expand(
            -1, -1, ga.TILE, -1, ga.TILE).reshape(
                bsz, tiles_y * ga.TILE, tiles_x * ga.TILE)[:, :height, :width]
        drop = bad | r.unsure
        keep = ~drop
        skipped += int(drop.sum())
        px += drop.numel()
        if bool(keep.any()):
            img = max(img, float((prog["image"][sl].to(dev) - r.image).abs()
                                 .amax(-1)[keep].max()))
            alp = max(alp, float((prog["alpha"][sl].to(dev)
                                  - r.alpha).abs()[keep].max()))
    return {"vert_gap": vert, "mean_gap": mean,
            "rect_mismatch": rect_diff / max(n_gauss, 1),
            "image_gap": img, "alpha_gap": alp,
            "image_skipped": skipped / max(px, 1)}


# --- faults planted under the timed path (the tests, and limit readings
# on the card); each is undone when the kind is freed ---

def _patch(kind, module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    kind.undo.append(lambda: setattr(module, name, real))


def no_sort(kind):
    """The pairs sorted by tile alone: each tile blends its Gaussians in
    id order."""
    import facerecon_tpu_torch.ops.gavatar as G

    def by_tile(keys):
        order = torch.sort(keys >> 32, stable=True).indices
        return keys[order], order
    _patch(kind, G, "sort_pairs", by_tile)


def near_ties(kind):
    """Depth near-ties blended in id order: the pairs sorted by tile and
    by their view depth rounded to 1e-6 m."""
    import facerecon_tpu_torch.ops.gavatar as G

    def rounded(keys):
        depth = (keys & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
        coarse = torch.round(depth.double() * 1e6).to(torch.int64)
        order = torch.sort(((keys >> 32) << 32) | coarse, stable=True).indices
        return keys[order], order
    _patch(kind, G, "sort_pairs", rounded)


def _plain_preprocess(kind, **consts):
    """The preprocess through its plain version with module constants of
    ops/gavatar set otherwise while it runs."""
    import facerecon_tpu_torch.ops.gavatar as G
    plain = G.preprocess_reference

    def preprocess(*a, **k):
        saved = {n: getattr(G, n) for n in consts}
        for n, v in consts.items():
            setattr(G, n, v)
        try:
            return plain(*a, **k)
        finally:
            for n, v in saved.items():
                setattr(G, n, v)
    _patch(kind, G, "preprocess", preprocess)


def no_dilation(kind):
    """No 0.3 on the 2D covariance's diagonal."""
    _plain_preprocess(kind, DILATION=0.0)


def unit_scale(kind):
    """The binding's scale k taken as 1."""
    import facerecon_tpu_torch.ops.gavatar as G
    frames = G.face_frames

    def unit(*v):
        rot, k, t = frames(*v)
        return rot, torch.ones_like(k), t
    _plain_preprocess(kind, face_frames=unit)


def sh0(kind):
    """The colour of SH degree 0 only: the other 15 coefficients zero."""
    sh = kind.avatar.sh.clone()
    sh[:, 3:] = 0.0
    kind.avatar = dataclasses.replace(kind.avatar, sh=sh)


FAULTS = {"no_sort": no_sort, "no_dilation": no_dilation, "sh0": sh0,
          "unit_scale": unit_scale, "near_ties": near_ties}
