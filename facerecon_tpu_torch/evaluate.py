"""Fidelity evaluation driver (twin of facerecon_tpu/evaluate.py) — the
acceptance-metric harness (BASELINE.md): renders N sampled coefficient
draws on the torch device and reports vertex MAE, rendered PSNR, landmark
RMSE and tri_id agreement against the CPU oracle (native C++ when it
builds, numpy otherwise).

  python -m facerecon_tpu_torch.evaluate --faces 4 --tiny --device cpu
  python -m facerecon_tpu_torch.evaluate --faces 4      # full scale, card

The render is render_coeffs with the reference's default, the training
render (kernel K2 on the card), under torch.no_grad(). Prints one JSON
line; "backend" is the torch device.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from facerecon_tpu_torch import oracle
from facerecon_tpu_torch.config import default_config, tiny_config
from facerecon_tpu_torch.data.synthetic import sample_coeffs
from facerecon_tpu_torch.ops.geometry import device_bfm
from facerecon_tpu_torch.ops.render import render_coeffs
from facerecon_tpu_torch.utils import native_oracle
from facerecon_tpu_torch.utils.bfm import load_npz, synthetic_bfm
from facerecon_tpu_torch.utils.coeffs import split_coeff
from facerecon_tpu_torch.utils.metrics import landmark_rmse, psnr, vertex_mae


def run(faces: int = 4, *, tiny: bool = False, seed: int = 0,
        bfm: Optional[str] = None, device="cuda") -> dict:
    cfg = tiny_config() if tiny else default_config()
    assets = load_npz(bfm) if bfm else synthetic_bfm(cfg, seed=0)
    dbfm = device_bfm(assets, device)
    rng = np.random.default_rng(seed)
    coeff = sample_coeffs(rng, cfg, faces)

    with torch.no_grad():
        c = split_coeff(torch.as_tensor(coeff, device=dbfm.faces.device),
                        cfg)
        out = render_coeffs(c, dbfm, cfg)
        image, tri_id, verts, lmk = (
            t.cpu().numpy() for t in (out.image, out.tri_id,
                                      out.geometry.verts_world,
                                      out.geometry.landmarks2d))

    vmae, psnrs, lrmse, agree = [], [], [], []
    raster = (native_oracle.rasterize if native_oracle.is_available()
              else None)
    for b in range(faces):
        ref = oracle.render_coeffs(coeff[b], assets, cfg, rasterize_fn=raster)
        vmae.append(vertex_mae(verts[b], ref["verts"]))
        psnrs.append(psnr(np.clip(image[b], 0, 1),
                          np.clip(ref["image"], 0, 1)))
        lrmse.append(landmark_rmse(lmk[b], ref["landmarks2d"]))
        agree.append(float((tri_id[b] == ref["tri_id"]).mean()))

    report = {
        "faces": faces,
        "backend": str(dbfm.faces.device),
        "vertex_mae": float(np.max(vmae)),
        "render_psnr_db_min": float(np.min(psnrs)),
        "landmark_rmse_px": float(np.max(lrmse)),
        "tri_id_agreement_min": float(np.min(agree)),
        "meets_contract": bool(np.max(vmae) < 1e-3),
    }
    print(json.dumps(report))
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--faces", type=int, default=4)
    p.add_argument("--bfm", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, or cpu for the "
                        "plain PyTorch path)")
    return run(**vars(p.parse_args(argv)))


if __name__ == "__main__":
    main()
