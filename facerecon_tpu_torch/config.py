"""Single frozen-dataclass config (SURVEY.md §3 C21).

All coefficient dims, camera constants, loss weights, and the FALLBACK
rasterizer's tile parameters live here. Defaults follow the
Deep3DFace-family convention pinned in SURVEY.md §9 (coeff layout
[id 80 | exp 64 | tex 80 | angles 3 | gamma 27 | t 3] = 257; camera f=1015,
c=10 for a 224x224 plane).

`model` picks the face model: "bfm" (the default, Deng et al.'s Basel
Face Model layout) or "flame" (DECA's coarse model on FLAME,
arXiv:2012.04012: codes [shape 100 | tex 50 | exp 50 | pose 6 | cam 3 |
light 27] = 236, a 256^2 UV albedo, an orthographic camera, and a
two-layer regressor head of `head_hidden` units). `deca_config` gives
DECA's published sizes; the FLAME-only fields are read only when
model == "flame", so every BFM default is unchanged. `n_detail` > 0 adds
DECA's detail model (`deca_config(n_detail=128)`): a detail code of
n_detail values after the coarse 236 (regressed by a second encoder),
decoded to a displacement map of uv_size^2 texels (models/deca_detail.py,
ops/detail.py); 0, the default, is the coarse model. DECA's pose, camera
and light groups have one layout only (DECA_FIXED), so they are no
fields. `is_flame` reads the model of any config, the JAX package's
included (which has no `model` and is a BFM config).

The Pallas TPU kernel's lane/window constants (_CHUNK, _WINDOW, _COL_W, the
head/mid DMA split) are HARDWARE-LAYOUT constants, not workload knobs: they
encode the v5e vreg geometry (128 lanes, 8 sublanes) and measured DMA
sizing, and live next to the kernel in ops/rasterize_pallas.py. Only
`tile_h` is shared; `tile_w`/`max_tris_per_tile`/`tri_chunk` configure the
non-Pallas fallback paths (ops/rasterize_tiled.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# DECA's pose (global rotation | jaw, axis-angle), cam (orthographic s,
# tx, ty) and light (SH-9 x RGB, coefficient-major) groups: the one
# layout its code has (utils/coeffs.DECACodes)
DECA_FIXED = (6, 3, 27)


@dataclasses.dataclass(frozen=True)
class FaceReconConfig:
    # --- face model: "bfm" or "flame" (DECA's coarse model) ---
    model: str = "bfm"

    # --- coefficient layout (SURVEY.md §9, total 257 by default) ---
    n_id: int = 80
    n_exp: int = 64
    n_tex: int = 80
    n_angles: int = 3
    n_gamma: int = 27  # 9 SH coeffs per RGB channel
    n_trans: int = 3

    # --- DECA's code layout on FLAME (model == "flame"; n_tex and n_exp
    # above are DECA's 50 and 50 there, then pose, cam and light) ---
    n_shape: int = 100
    uv_size: int = 256     # albedo texels a side after the downsample
    head_hidden: int = 1024  # the regressor head's hidden layer
    n_detail: int = 0      # DECA's detail code (128); 0 = coarse only

    # --- mesh dims (configurable; full BFM09: 53490, cropped: 35709) ---
    n_vertices: int = 35709
    n_faces: int = 70789
    n_landmarks: int = 68

    # --- camera (SURVEY.md §9.3) ---
    image_size: int = 224
    focal: float = 1015.0
    camera_distance: float = 10.0

    # --- loss weights (SURVEY.md §9.7; tunable, not contractual) ---
    w_photo: float = 1.9
    # landmark_loss already divides by image_size^2 (SURVEY.md §9.7), so this
    # weight is O(100): 80/224^2 == the family's usual 1.6e-3 per-px^2 scale.
    w_landmark: float = 80.0
    w_reg_id: float = 1.0
    w_reg_exp: float = 0.8
    w_reg_tex: float = 1.7e-2
    w_reg_scale: float = 3e-4
    w_gamma: float = 10.0
    # optional flat-albedo prior (SURVEY.md §9.7): variance of the skin
    # albedo; 0 disables (the reference family's default behavior)
    w_tex_var: float = 0.0
    landmark_weight_inner: float = 20.0  # nose + inner mouth up-weight

    # --- rasterizer tiling (SURVEY.md §9.5) ---
    # band height in pixel rows, shared by the Pallas kernel and the tiled
    # fallback. 4 (with raster_cols=7 -> 32px columns, col_px=128 full
    # vregs) measured fastest at 224px on v5e once the looped chunk eval
    # removed the Mosaic unroll wall: half the per-program skeleton of
    # tile_h=2 at near-equal pair count (floor 61.4 -> 50.3 ms/128;
    # tile_h=8 x 14cols measured 54.4 — taller bands widen the union
    # windows faster than the skeleton shrinks).
    tile_h: int = 4
    # Pallas kernel: column tiles per band. Each column evaluates only
    # the candidate chunks whose EXACT per-chunk bitmask bit is set; 7
    # keeps tile_w=224 pad-free at 224px with 128-px column tiles.
    raster_cols: int = 7
    # fallback (ops/rasterize_tiled.py) tile width
    tile_w: int = 128
    # fallback: max candidate triangles per tile after binning
    max_tris_per_tile: int = 4096
    # fallback: triangle chunk processed per inner step
    tri_chunk: int = 512

    # --- training ---
    batch_size: int = 32
    learning_rate: float = 1e-4
    train_steps: int = 200_000
    checkpoint_every: int = 5_000

    def __post_init__(self):
        if self.model not in ("bfm", "flame"):
            raise ValueError(f"unknown face model {self.model!r}: "
                             "expected 'bfm' or 'flame'")
        if self.n_detail and self.model != "flame":
            raise ValueError("n_detail > 0 needs model='flame' (DECA)")

    @property
    def coeff_sizes(self) -> Tuple[int, ...]:
        """The code's groups in order: [id | exp | tex | angles | gamma |
        t] for BFM, [shape | tex | exp | pose | cam | light] for FLAME."""
        if is_flame(self):
            detail = (self.n_detail,) if self.n_detail else ()
            return (self.n_shape, self.n_tex, self.n_exp, *DECA_FIXED,
                    *detail)
        return (self.n_id, self.n_exp, self.n_tex, self.n_angles,
                self.n_gamma, self.n_trans)

    @property
    def n_coeff(self) -> int:
        return sum(self.coeff_sizes)

    @property
    def n_coarse(self) -> int:
        """The codes the coarse encoder regresses (all but the detail
        code)."""
        return self.n_coeff - (self.n_detail if is_flame(self) else 0)

    @property
    def coeff_split(self) -> Tuple[int, ...]:
        """Cumulative split points for jnp.split over the coeff axis."""
        sizes = self.coeff_sizes[:-1]
        out, acc = [], 0
        for s in sizes:
            acc += s
            out.append(acc)
        return tuple(out)

    @property
    def center(self) -> float:
        return self.image_size / 2.0


def is_flame(cfg) -> bool:
    """Whether cfg is a FLAME (DECA) config; the JAX package's config,
    which the port's tests pass, has no `model` and is a BFM one."""
    return getattr(cfg, "model", "bfm") == "flame"


def default_config(**overrides) -> FaceReconConfig:
    return FaceReconConfig(**overrides)


def deca_config(**overrides) -> FaceReconConfig:
    """DECA's coarse model on FLAME at its published sizes (5,023
    vertices, 9,976 faces, 68 landmarks, 236 codes, a 256^2 albedo, 224
    px), with the BFM render's 4-row bands x 7 column tiles; n_detail=128
    adds the detail model."""
    base = dict(model="flame", n_tex=50, n_exp=50, n_vertices=5023,
                n_faces=9976, image_size=224, tile_h=4, raster_cols=7)
    base.update(overrides)
    return FaceReconConfig(**base)


def tiny_config(**overrides) -> FaceReconConfig:
    """Small mesh + image for fast CPU tests."""
    # tile_h/raster_cols stay at the round-4 CPU-test geometry: the
    # production 4x7 tiling is sized for 224px on hardware; at 64px it
    # pads the 64-px row to a 112-px tile (pure interpret-mode waste)
    base = dict(n_vertices=500, n_faces=900, image_size=64,
                focal=1015.0 * 64 / 224, max_tris_per_tile=1024,
                tri_chunk=128, batch_size=4, tile_h=2, raster_cols=2)
    base.update(overrides)
    return FaceReconConfig(**base)
