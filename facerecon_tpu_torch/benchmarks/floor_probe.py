"""One rasterizer kernel alone on inputs precomputed once (twin of
benchmarks/floor_probe.py, kernel K5), with phases stripped by
RP_ABLATE, to attribute the skeleton's time:

  python -m facerecon_tpu_torch.benchmarks.floor_probe            # full
  RP_ABLATE=sel,eval,dma,pack python -m \\
      facerecon_tpu_torch.benchmarks.floor_probe                  # skeleton
  SIZE=64 BATCH=2 NCOLS=2 python -m \\
      facerecon_tpu_torch.benchmarks.floor_probe --device cpu     # plain

env: SIZE (224), BATCH (128), TILEH (2), NCOLS (4) as the reference's;
FLOOR_MASK=ones saturates the chunk masks (every chunk of a window's
first 64 is tested; the values are not the function, the time is);
FLOOR_KMODE select (K2, the default), shade (K1) or pos (K4); RP_ABLATE,
comma-separated phases to strip: the reference's dma, eval, sel and pack
and the port's cull and merge (csrc/raster_common.cuh says what each
strips in the port). Two departures from the reference: an unknown name
raises (the reference ignores it), and RP_ABLATE is read here only (the
reference's kernel reads it in every call it traces; the port's
wrappers never build a variant). `sel` with FLOOR_KMODE=pos raises: K4
loads no record. The values of an ablated build are not checked here.

The inputs are the reference's `produce`, made once: the mean face
(sample_coeffs(default_rng(0), scale=0.0)) at default_config's mesh,
its band windows and 24-field records. On the card this module launches
the kernel itself through ops/_build.launch (the variant with the
RP_ABLATE macros set), as the reference builds its own pallas_call; on
the CPU it calls the kernel's plain version, which has no phases, so
RP_ABLATE there raises. Timing is the chained timer (_timing.timed,
inner 8, reps 3): each call takes the previous call's scalar through
`blo`, as the reference's scan does, and its first chain (the build and
first launch) prints as `compile Ns`. `--device` (default cuda) raises
without a card unless it is "cpu".
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from facerecon_tpu_torch.bench import _device
from facerecon_tpu_torch.benchmarks import _timing
from facerecon_tpu_torch.config import default_config
from facerecon_tpu_torch.data.synthetic import sample_coeffs
from facerecon_tpu_torch.ops import _build
from facerecon_tpu_torch.ops import rasterize as R
from facerecon_tpu_torch.ops.geometry import coeffs_to_geometry, device_bfm
from facerecon_tpu_torch.ops.render import pack_render_records
from facerecon_tpu_torch.ops.sh import illuminate
from facerecon_tpu_torch.utils.bfm import synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff

INNER, REPS = 8, 3
# FLOOR_KMODE -> the kernel (ops/_build.KERNELS)
MODES = {"select": "raster_select", "shade": "raster_shade",
         "pos": "raster_pos"}
# RP_ABLATE name -> the macro of its variant build
ABLATE = {"dma": "RP_ABLATE_DMA", "eval": "RP_ABLATE_EVAL",
          "sel": "RP_ABLATE_SEL", "pack": "RP_ABLATE_PACK",
          "cull": "RP_ABLATE_CULL", "merge": "RP_ABLATE_MERGE"}
PLAIN = {"select": R.select_windows_reference,
         "shade": R.shade_windows_reference,
         "pos": lambda win, rec, **kw: R.pos_windows_reference(win, **kw)}


def knobs() -> dict:
    env = os.environ.get
    return dict(size=int(env("SIZE", "224")), batch=int(env("BATCH", "128")),
                tile_h=int(env("TILEH", "2")), n_cols=int(env("NCOLS", "4")),
                mask=env("FLOOR_MASK", ""), mode=env("FLOOR_KMODE", "select"),
                ablate=env("RP_ABLATE", ""))


def kernel(mode: str) -> str:
    """The kernel FLOOR_KMODE names; raises on any other mode."""
    if mode not in MODES:
        raise ValueError(f"FLOOR_KMODE={mode!r}: expected one of "
                         f"{', '.join(MODES)}")
    return MODES[mode]


def ablation(setting: str, mode: str) -> tuple[str, ...]:
    """The macros of an RP_ABLATE setting for FLOOR_KMODE `mode`, sorted.
    Raises on a name that is not a phase, and on `sel` in pos mode."""
    names = [n.strip() for n in setting.split(",") if n.strip()]
    unknown = [n for n in names if n not in ABLATE]
    if unknown:
        raise ValueError(f"RP_ABLATE: unknown phase(s) {unknown}; the "
                         f"phases are {', '.join(ABLATE)}")
    if mode == "pos" and "sel" in names:
        raise ValueError("RP_ABLATE=sel with FLOOR_KMODE=pos: K4 loads no "
                         "record, so it has no select to strip")
    return _build.macros(ABLATE[n] for n in names)


@torch.no_grad()
def geometry(size: int, batch: int, tile_h: int, device, cfg=None,
             assets=None):
    """The mean face (sample_coeffs(default_rng(0), scale=0.0)) at
    default_config(image_size=size, focal scaled, tile_h) (or `cfg`) on
    synthetic_bfm(cfg, 0) (or `assets`): (verts_ndc, radiance, raster
    rows, their face ids, n_faces)."""
    dev = _device(device)
    if cfg is None:
        cfg = default_config(image_size=size, focal=1015.0 * size / 224.0,
                             tile_h=tile_h)
    assets = synthetic_bfm(cfg, seed=0) if assets is None else assets
    bfm = device_bfm(assets, dev)
    cv = torch.as_tensor(sample_coeffs(np.random.default_rng(0), cfg, batch,
                                       scale=0.0), device=dev)
    c = split_coeff(cv, cfg)
    geom = coeffs_to_geometry(c, bfm, cfg)
    rad = illuminate(geom.texture, geom.normals, c.gamma)
    return (geom.verts_ndc, rad, bfm.raster_rows, bfm.raster_row_id,
            assets.n_faces)


@torch.no_grad()
def produce(verts_ndc, radiance, rows, rid, size: int, tile_h: int,
            n_cols: int):
    """The reference's `produce`: the band windows (Windows) and the
    24-field records (B, 24, rows) in raster row order."""
    win = R.band_windows(verts_ndc, rows, rid, size, size, tile_h, n_cols)
    rec = pack_render_records(verts_ndc, radiance, rows, size, size,
                              R.padded_rows(rows.shape[0]))
    return win, rec


def inputs(size: int, batch: int, tile_h: int, n_cols: int, device,
           cfg=None, assets=None):
    """`geometry` and `produce`, once: (Windows, records, n_faces)."""
    vndc, rad, rows, rid, n_faces = geometry(size, batch, tile_h, device,
                                             cfg, assets)
    return (*produce(vndc, rad, rows, rid, size, tile_h, n_cols), n_faces)


def saturate(win: R.Windows) -> R.Windows:
    """FLOOR_MASK=ones: every mask bit set."""
    return win._replace(cmask=torch.full_like(win.cmask, -1))


def outputs(mode: str, batch: int, size: int, dev, fill=None):
    """The kernel's outputs as its wrapper allocates them (ops/rasterize),
    or filled with `fill` where given."""
    i32, f32 = torch.int32, torch.float32
    px = (batch, size, size)
    shapes = {"shade": ((i32, px), (f32, px + (3,)), (f32, px + (3,))),
              "select": ((i32, px), (i32, px),
                         (f32, (batch, R._SEL, size, size))),
              "pos": ((i32, px), (f32, px), (i32, px))}[mode]
    if fill is None:
        return tuple(torch.empty(s, dtype=d, device=dev) for d, s in shapes)
    return tuple(torch.full(s, fill, dtype=d, device=dev) for d, s in shapes)


def launch(mode: str, win: R.Windows, rec, outs, *, size: int, tile_h: int,
           n_cols: int, n_faces: int, defines=()) -> None:
    """Launch the mode's kernel (the variant with `defines` set) on CUDA
    tensors, writing `outs` (from `outputs`)."""
    dev = win.setup.device
    if not _build.on_card(dev):
        raise ValueError("launch takes CUDA tensors; the CPU has the plain "
                         "versions (call)")
    R._check_inputs(win, None if mode == "pos" else rec, size, size, tile_h,
                    n_cols)
    ptrs = ((win.setup,) + (() if mode == "pos" else (rec,))
            + (win.blo, win.bn, win.cmask) + tuple(outs))
    _build.launch(kernel(mode), dev, ptrs,
                  R._raster_ints(win, size, size, tile_h, n_cols, n_faces),
                  defines)


def call(mode: str, win: R.Windows, rec, *, size: int, tile_h: int,
         n_cols: int, n_faces: int, defines=()):
    """The kernel alone: launched here on CUDA tensors, its plain version
    on CPU tensors (which raises if `defines` strips a phase)."""
    kw = dict(size=size, tile_h=tile_h, n_cols=n_cols, n_faces=n_faces)
    dev = win.setup.device
    if not _build.on_card(dev):
        if defines:
            raise ValueError("RP_ABLATE needs the card: the plain versions "
                             "have no phases to strip")
        return PLAIN[mode](win, rec, height=size, width=size, tile_h=tile_h,
                           n_cols=n_cols, n_faces=n_faces)
    outs = outputs(mode, win.setup.shape[0], size, dev)
    launch(mode, win, rec, outs, defines=defines, **kw)
    return outs


def run(k: dict, device, cfg=None, assets=None) -> _timing.Case:
    """The reference's main on the knobs `k`: inputs, then the chosen
    kernel alone, timed. Returns its Case."""
    dev = _device(device)
    mode, setting = k["mode"], k["ablate"]
    name = kernel(mode)
    defines = ablation(setting, mode)
    if defines and dev.type != "cuda":
        raise ValueError(f"RP_ABLATE={setting} needs --device cuda: the "
                         f"plain versions have no phases to strip")
    size, tile_h, n_cols = k["size"], k["tile_h"], k["n_cols"]
    win, rec, n_faces = inputs(size, k["batch"], tile_h, n_cols, dev, cfg,
                               assets)
    if k["mask"] == "ones":
        win = saturate(win)
    print("inputs ready", tuple(win.setup.shape), tuple(rec.shape),
          flush=True)

    def one(blo, bn, cmask, setup, rec, seed):
        w = R.Windows(blo + (seed * 1e-30).to(torch.int32), bn, cmask, setup)
        out = call(mode, w, rec, size=size, tile_h=tile_h, n_cols=n_cols,
                   n_faces=n_faces, defines=defines)
        return out[0][0, 0, 0].to(torch.float32)
    cases = []
    _timing.timed(_build.SYMBOLS[name], one, win.blo, win.bn, win.cmask,
                  win.setup, rec, inner=INNER, reps=REPS,
                  line=("{tag} alone (RP_ABLATE=" + setting
                        + "): {ms:7.1f} ms/{b}"),
                  cases=cases, first_line="compile {ct:.0f}s", seeded=True)
    return cases[0]


def main(argv=None) -> _timing.Case:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(knobs(), args.device)


if __name__ == "__main__":
    main()
