"""MATLAB BFM pack -> .npz asset converter — SURVEY.md §3 C1.

The twin of facerecon_tpu/convert_assets.py, on the port's utils/bfm.py.

The reference family loads licensed Basel Face Model data from MATLAB
`.mat` files at runtime (SURVEY.md §3 C1: `scipy.io.loadmat`); this
framework loads a `.npz` pack (utils/bfm.py). This tool bridges the two:
point it at the licensed `.mat` you obtained and it writes the `.npz`
drop-in, deriving the adjacency tables and raster row order on the way.

Two public `.mat` layouts are recognized (key names are the published
file formats, not code):

  * Deep3DFace-style `BFM_model_front.mat`:
      meanshape (1,3N) / idBase (3N,80) / exBase (3N,64) /
      meantex (1,3N) / texBase (3N,80) / tri (F,3) 1-indexed /
      keypoints (1,68) 1-indexed / skinmask (1,N).
    Its bases are pre-scaled by the PCA eigenvalue sqrt, so sigma_* = 1.
  * Original BFM09 `01_MorphableModel.mat`:
      shapeMU (3N,1) / shapePC (3N,199) / shapeEV (199,1) /
      texMU / texPC / texEV / tl (F,3) 1-indexed.
    Bases stay unscaled; sigma_* = the EV sqrt arrays, truncated to the
    requested coefficient counts. It has no expression basis, keypoints,
    or skin mask — those must come from side files or defaults (zeros /
    first-68 / ones), reported loudly.

Usage:
  python -m facerecon_tpu_torch.convert_assets BFM_model_front.mat bfm.npz
  python -m facerecon_tpu_torch.convert_assets 01_MorphableModel.mat bfm.npz \
      --n-id 80 --n-exp 64 --n-tex 80
"""

from __future__ import annotations

import argparse

import numpy as np

from facerecon_tpu_torch.utils.bfm import (BFMAssets, raster_row_order,
                                           save_npz, vertex_face_adjacency)


def _flat(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).reshape(-1)


def _from_deep3d(m: dict) -> dict:
    """Deep3DFace-style keys -> BFMAssets field dict (sans derived)."""
    mean_shape = _flat(m["meanshape"])
    n = mean_shape.shape[0] // 3
    out = dict(
        mean_shape=mean_shape,
        id_basis=np.asarray(m["idBase"], np.float32),
        exp_basis=np.asarray(m["exBase"], np.float32),
        mean_tex=_flat(m["meantex"]),
        tex_basis=np.asarray(m["texBase"], np.float32),
        faces=np.asarray(m["tri"], np.int64).reshape(-1, 3) - 1,
    )
    # bases arrive eigenvalue-scaled: unit-normal coefficients already
    # deform at natural scale, so the 1/sigma Tikhonov reg uses sigma=1
    out["sigma_id"] = np.ones(out["id_basis"].shape[1], np.float32)
    out["sigma_exp"] = np.ones(out["exp_basis"].shape[1], np.float32)
    out["sigma_tex"] = np.ones(out["tex_basis"].shape[1], np.float32)
    if "keypoints" in m:
        out["landmark_index"] = (
            np.asarray(m["keypoints"], np.int64).reshape(-1) - 1)
    if "skinmask" in m:
        out["skin_mask"] = _flat(m["skinmask"])[:n]
    return out


def _from_bfm09(m: dict, n_id: int, n_exp: int, n_tex: int) -> dict:
    """Original BFM09 01_MorphableModel.mat keys -> field dict."""
    shape_pc = np.asarray(m["shapePC"], np.float32)
    tex_pc = np.asarray(m["texPC"], np.float32)
    out = dict(
        mean_shape=_flat(m["shapeMU"]),
        id_basis=shape_pc[:, :n_id],
        sigma_id=_flat(m["shapeEV"])[:n_id],
        mean_tex=_flat(m["texMU"]),
        tex_basis=tex_pc[:, :n_tex],
        sigma_tex=_flat(m["texEV"])[:n_tex],
        faces=np.asarray(m["tl"], np.int64).reshape(-1, 3) - 1,
    )
    # BFM09 ships no expression basis (the family grafts FaceWarehouse's);
    # emit a zero basis of the requested width so shapes stay drop-in
    out["exp_basis"] = np.zeros((out["mean_shape"].shape[0], n_exp),
                                np.float32)
    out["sigma_exp"] = np.ones(n_exp, np.float32)
    return out


def convert(mat_path: str, out_path: str, n_id: int = 80, n_exp: int = 64,
            n_tex: int = 80, exp_mat: str | None = None,
            verbose: bool = True) -> BFMAssets:
    """Load a `.mat` BFM pack, derive the framework's tables, save `.npz`.

    exp_mat: optional side `.mat` holding an expression basis for BFM09
    inputs (keys `expPC`/`expEV` or `exBase`).
    """
    import scipy.io
    m = scipy.io.loadmat(mat_path)
    if "meanshape" in m:
        fields = _from_deep3d(m)
    elif "shapeMU" in m:
        fields = _from_bfm09(m, n_id, n_exp, n_tex)
    else:
        raise ValueError(
            f"{mat_path}: unrecognized BFM .mat layout — expected "
            "Deep3DFace keys (meanshape/idBase/...) or BFM09 keys "
            "(shapeMU/shapePC/...), got " + ", ".join(sorted(m)[:12]))
    if exp_mat is not None:
        e = scipy.io.loadmat(exp_mat)
        if "exBase" in e:
            fields["exp_basis"] = np.asarray(e["exBase"], np.float32)
            fields["sigma_exp"] = np.ones(fields["exp_basis"].shape[1],
                                          np.float32)
        elif "expPC" in e:
            fields["exp_basis"] = np.asarray(e["expPC"],
                                             np.float32)[:, :n_exp]
            fields["sigma_exp"] = _flat(e["expEV"])[:n_exp]
        else:
            raise ValueError(f"{exp_mat}: no expression basis key "
                             "(exBase or expPC) found")

    n = fields["mean_shape"].shape[0] // 3
    faces = fields["faces"]
    if faces.min() < 0 or faces.max() >= n:
        raise ValueError(
            f"triangle indices out of range after 1->0 conversion "
            f"(min {faces.min()}, max {faces.max()}, N={n})")
    fields["faces"] = faces.astype(np.int32)
    defaults = []
    if "landmark_index" not in fields:
        fields["landmark_index"] = np.arange(68, dtype=np.int32)
        defaults.append("landmark_index (no keypoints key: first 68 "
                        "vertices — supply real indices for training)")
    if "skin_mask" not in fields:
        fields["skin_mask"] = np.ones(n, np.float32)
        defaults.append("skin_mask (no skinmask key: all-ones)")
    fields["landmark_index"] = np.asarray(fields["landmark_index"],
                                          np.int32)
    fields["skin_mask"] = np.asarray(fields["skin_mask"], np.float32)

    adj, corner_adj, face_slot = vertex_face_adjacency(
        fields["faces"], n, with_corners=True)
    rows, row_id = raster_row_order(fields["faces"], fields["mean_shape"])
    assets = BFMAssets(vertex_face_adj=adj, vertex_corner_adj=corner_adj,
                       face_adj_slot=face_slot, raster_rows=rows,
                       raster_row_id=row_id, **fields)
    save_npz(out_path, assets)
    if verbose:
        print(f"{mat_path}: N={assets.n_vertices} F={assets.n_faces} "
              f"K=({assets.id_basis.shape[1]},{assets.exp_basis.shape[1]},"
              f"{assets.tex_basis.shape[1]}) -> {out_path}")
        for d in defaults:
            print(f"  WARNING: defaulted {d}")
    return assets


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mat", help="input .mat BFM pack")
    p.add_argument("out", help="output .npz asset pack")
    p.add_argument("--exp-mat", default=None,
                   help="side .mat with an expression basis (BFM09 inputs)")
    p.add_argument("--n-id", type=int, default=80)
    p.add_argument("--n-exp", type=int, default=64)
    p.add_argument("--n-tex", type=int, default=80)
    a = p.parse_args(argv)
    convert(a.mat, a.out, n_id=a.n_id, n_exp=a.n_exp, n_tex=a.n_tex,
            exp_mat=a.exp_mat)


if __name__ == "__main__":
    main()
