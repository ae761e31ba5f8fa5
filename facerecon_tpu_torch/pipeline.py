"""Reconstruction pipeline (twin of facerecon_tpu/pipeline.py).

images -> ResNet -> coefficients -> geometry -> SH-9 radiance -> fused
rasterizer -> composite over the input image. PyTorch runs eagerly, so
there is no jit:
  - `make_pipeline` holds the BN-folded inference model, and
    `Pipeline.reconstruct` is the counterpart of the reference's
    `make_reconstruct_fn(inference)`;
  - `make_train_pipeline` holds the BatchNorm training model, and
    `regress_coeffs` its forward (train.py builds the step on it);
  - `fuse_for_inference` folds a BatchNorm pipeline's model into the
    fused one (models/fused.fold_bn_model), e.g. for a checkpoint the
    port trained.
A FLAME config (cfg.model == "flame") with FLAME assets (utils/flame)
runs DECA's coarse model on the same entry points: the ResNet with
DECA's two-layer float32 head regresses 236 codes, which are split
(utils/coeffs.DECACodes) and rendered through FLAME, the UV albedo and
the textured raster (ops/render.render_flame), composited over zeros as
DECA's renderer does. A detail config (cfg.n_detail > 0) adds DECA's
detail encoder E_d (`detail_model`: the same backbone, a two-layer head
of n_detail outputs), whose code follows the coarse ones, and renders the
detailed image through the pack's decoder (`decoder` of the
constructors, a models/deca_detail.DetailGenerator, which a detail
config requires).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from facerecon_tpu_torch import resolve_device
from facerecon_tpu_torch.config import FaceReconConfig, is_flame
from torch import nn

from facerecon_tpu_torch.models.fused import (FusedResNetRegressor,
                                              build_fused_model, fold_bn_model)
from facerecon_tpu_torch.models.resnet import build_model
from facerecon_tpu_torch.ops.flame import device_flame
from facerecon_tpu_torch.ops.geometry import DeviceBFM, device_bfm
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.profile_trace import span
from facerecon_tpu_torch.utils.bfm import BFMAssets
from facerecon_tpu_torch.utils.coeffs import split_coeff
from facerecon_tpu_torch.utils.flame import FLAMEAssets


@dataclasses.dataclass
class Pipeline:
    cfg: FaceReconConfig
    bfm: DeviceBFM     # or DeviceFLAME for a FLAME config
    model: nn.Module   # FusedResNetRegressor, or ResNetRegressor to train
    device: torch.device
    detail_model: Optional[nn.Module] = None  # DECA's E_d (n_detail > 0)

    @torch.no_grad()
    def reconstruct(self, images, background: Optional[torch.Tensor] = None,
                    inference: bool = True):
        """images (B,H,W,3) in [0,1] (tensor or array) -> (coeff vector
        (B, n_coeff), Coeffs, RenderOut) on the pipeline's device.

        inference=True renders through the forward-only shaded kernel
        (K1); inference=False through the training render's select (K2),
        as the reference's make_reconstruct_fn(pipe) does by default.

        The model runs in eval mode, as the reference's reconstruct runs
        it with train=False: a BatchNorm model normalises with its running
        statistics and leaves them as they are. The model's mode is
        restored afterwards.

        A FLAME pipeline returns DECA's codes (B, 236), DECACodes and the
        textured render, composited over `background` or, by default,
        over zeros (DECA's); it renders for inference only. With the
        detail encoder the codes are (B, 236 + n_detail), E_c's then
        E_d's, and the render is the detailed image."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        models = [m for m in (self.model, self.detail_model)
                  if m is not None]
        was = [m.training for m in models]
        try:
            with span("fr.cnn"):
                coeff_vec = self.model.eval()(images)
                if self.detail_model is not None:
                    coeff_vec = torch.cat(
                        [coeff_vec, self.detail_model.eval()(images)], dim=1)
        finally:
            for m, w in zip(models, was):
                m.train(w)
        coeffs = split_coeff(coeff_vec, self.cfg)
        if background is None and not is_flame(self.cfg):
            background = images
        out = render_coeffs(coeffs, self.bfm, self.cfg,
                            background=background, inference=inference)
        return coeff_vec, coeffs, out


def _pipeline(cfg, assets, device, model, detail_model=None,
              decoder=None) -> Pipeline:
    """Turns TF32 off for the process (geometry must stay true float32,
    and cuDNN would otherwise run float32 convolutions in TF32; the
    detail decoder turns it on for its own convolutions), then uploads
    the assets and the models."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = [m.to(dev, memory_format=torch.channels_last)
              if m is not None else None for m in (model, detail_model)]
    return Pipeline(cfg=cfg,
                    bfm=device_assets(assets, cfg, dev, decoder),
                    model=models[0], device=dev, detail_model=models[1])


def device_assets(assets, cfg: FaceReconConfig, device, decoder=None):
    """The assets of cfg's face model on the device: BFMAssets ->
    DeviceBFM, FLAMEAssets -> DeviceFLAME (the albedo's first cfg.n_tex
    components at cfg.uv_size; for a detail config with `decoder`, the
    detail decoder). Raises when the pack is not of cfg's model, or a
    detail config was given no decoder."""
    flame = is_flame(cfg)
    if flame != isinstance(assets, FLAMEAssets):
        raise ValueError(f"a {'FLAME' if flame else 'BFM'} config was "
                         f"given {type(assets).__name__}")
    if flame:
        if cfg.n_detail and decoder is None:
            raise ValueError("a detail config needs its decoder "
                             "(models/deca_detail.DetailGenerator)")
        return device_flame(assets, device, cfg.n_tex, cfg.uv_size,
                            decoder if cfg.n_detail else None)
    return device_bfm(assets, device)


def make_pipeline(cfg: FaceReconConfig, assets: BFMAssets, device="cuda",
                  dtype=torch.bfloat16, depth: int = 50, seed: int = 0,
                  decoder=None) -> Pipeline:
    """The inference pipeline: the fused regressor with random weights
    drawn from `seed` (load trained ones with
    `pipe.model.load_state_dict(jax_params.fused_state_dict(...))`); a
    detail config adds the fused detail encoder and the decoder."""
    def fused(n_out=0, k=0):
        return build_fused_model(cfg, depth, dtype, n_out).reset_parameters_(
            torch.Generator().manual_seed(seed + k)).eval()
    detail = fused(cfg.n_detail, 1) if _has_detail(cfg) else None
    return _pipeline(cfg, assets, device, fused(), detail, decoder)


def make_train_pipeline(cfg: FaceReconConfig, assets: BFMAssets,
                        device="cuda", dtype=torch.bfloat16, depth: int = 50,
                        seed: int = 0, decoder=None) -> Pipeline:
    """The training pipeline: the BatchNorm regressor, initialised as the
    reference initialises it from `seed` (carry flax variables over with
    `pipe.model.load_state_dict(jax_params.train_state_dict(...))`); a
    detail config adds the BatchNorm detail encoder and the decoder."""
    def bn(n_out=0, k=0):
        return build_model(cfg, depth, dtype, n_out).reset_parameters_(
            torch.Generator().manual_seed(seed + k)).train()
    detail = bn(cfg.n_detail, 1) if _has_detail(cfg) else None
    return _pipeline(cfg, assets, device, bn(), detail, decoder)


def _has_detail(cfg) -> bool:
    return is_flame(cfg) and cfg.n_detail > 0


def _fused(bn: nn.Module, device) -> FusedResNetRegressor:
    hidden = bn.head_hidden.out_features if bn.head_hidden is not None else 0
    fused = FusedResNetRegressor(bn.head.out_features, bn.stage_sizes,
                                 bn.width, bn.dtype, hidden)
    fused.load_state_dict(fold_bn_model(bn))
    return fused.to(device, memory_format=torch.channels_last).eval()


def fuse_for_inference(pipe: Pipeline) -> Pipeline:
    """Deploy-time transform of a BatchNorm pipeline: a pipeline on the
    same device and assets holding the fused model (BatchNorm folded
    from the running statistics, space-to-depth stem; exact to float32
    rounding) in the BN model's dtype, and the fused detail encoder where
    there is one. Training keeps the BN model."""
    detail = pipe.detail_model
    return dataclasses.replace(
        pipe, model=_fused(pipe.model, pipe.device),
        detail_model=None if detail is None else _fused(detail,
                                                        pipe.device))


def regress_coeffs(pipe: Pipeline, images, train: bool = False):
    """images (B,H,W,3) in [0,1] -> coefficient vector (B, n_coeff).

    train=True runs BatchNorm on the batch statistics and updates the
    model's running statistics in place (the reference returns them as
    new batch_stats); train=False uses the running statistics."""
    images = torch.as_tensor(images, dtype=torch.float32, device=pipe.device)
    pipe.model.train(train)
    with span("fr.cnn"):
        return pipe.model(images)
