"""Seeded stand-ins for a GaussianAvatars avatar (Qian et al.,
arXiv:2312.02069) and the camera rig it is rendered from.

The trained avatars (point_cloud.ply with the FLAME parameters of
NeRSemble's subjects) and FLAME 2023's files are not in the repository,
so the configuration's avatar is drawn from seeds at the published
sizes:

  FLAME    flame_data.flame_arrays' head (the configuration's `mesh` and
           `mesh_seed`) with n_shape + n_exp components (300 + 100); only
           its skinning arrays are kept (`FLAME_RAW`), the albedo is not
           drawn (two texels, one component);
  Gaussians (`gaussian_arrays`, from the configuration's `avatar_seed`):
    counts  per face 1 + its share of the rest in proportion to the
            template's face area (largest remainders), as GaussianAvatars
            starts from one a face and densifies where the surface is;
    xyz     a uniform point of the face (barycentrics), in the face's
            frame and units of its scale k (the template's), plus
            N(0, normal_offset) along the normal;
    rotation  a turn U(0, 2 pi) about the face normal (the frame's second
            axis), tilted by N(0, tilt) rad about the other two, as a
            unit quaternion (w, x, y, z);
    scaling log(plane_scale) + N(0, scale_jitter) in the face's plane,
            log(normal_scale) + N(0, scale_jitter) along its normal (flat
            surfels of about a quarter of the triangle's scale);
    opacity logit N(opacity_logit, opacity_sd) (mostly opaque);
    features  the DC term (c - 0.5) / C0 of a skin colour c = base + 0.1
            of a smooth field + N(0, colour_sd) per channel, and the
            degree-l coefficients N(0, rest_sd[l - 1]);
  cameras (`camera_rig`): `n_cameras` pinhole cameras on an arc before
           the head, `rows` rows at the pitches given and yaws evenly
           from yaw[0] to yaw[1], each `distance` m from `target` and
           looking at it (x right, y down, z forward), with focal length
           `focal` px in x and y and the principal point at the image's
           centre.
Everything depends only on the configuration and its seeds."""

from __future__ import annotations

import numpy as np

from perfbench import flame_data

FLAME_RAW = ("v_template", "shapedirs", "posedirs", "J_regressor",
             "lbs_weights", "parents", "faces")
SH_C0 = 0.28209479177387814


def flame_arrays(cfgf: dict) -> dict:
    """FLAME's stand-in skinning arrays at the configuration's sizes."""
    sizes = dict(cfgf["sizes"], n_tex=1, albedo_size=2)
    full = flame_data.flame_arrays(sizes, cfgf["mesh"], cfgf["mesh_seed"])
    return {k: full[k] for k in FLAME_RAW}


def face_frames64(verts, faces):
    """GaussianAvatars' face frames in float64 over a mesh (N, 3), (F, 3):
    rotations (F, 3, 3) with columns a0, a1, a2, scales (F,), origins
    (F, 3)."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))

    def unit(x):
        return x / np.sqrt(np.maximum((x * x).sum(-1, keepdims=True),
                                      1e-20))
    a0 = unit(v1 - v0)
    a1 = unit(np.cross(a0, v2 - v0))
    a2 = -unit(np.cross(a1, a0))
    k = (np.linalg.norm(v1 - v0, axis=-1)
         + np.abs((a2 * (v2 - v0)).sum(-1))) / 2
    return np.stack([a0, a1, a2], -1), k, (v0 + v1 + v2) / 3


def face_counts(area, n_gaussians: int) -> np.ndarray:
    """1 a face, and the rest in proportion to the area by largest
    remainders."""
    n_f = len(area)
    if n_gaussians < n_f:
        raise ValueError(f"{n_gaussians} Gaussians for {n_f} faces")
    share = (n_gaussians - n_f) * area / area.sum()
    extra = np.floor(share).astype(np.int64)
    left = n_gaussians - n_f - int(extra.sum())
    extra[np.argsort(-(share - extra), kind="stable")[:left]] += 1
    return 1 + extra


def gaussian_arrays(verts, faces, n_gaussians: int, seed: int,
                    st: dict) -> dict:
    """The Gaussians of the module's docstring on the template (verts,
    faces), st the configuration's `stand_ins`."""
    rng = np.random.default_rng(seed)
    verts = np.asarray(verts, np.float64)
    rot, k, origin = face_frames64(verts, faces)
    p = verts[faces]
    area = 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0],
                                         p[:, 2] - p[:, 0]), axis=-1)
    counts = face_counts(area, n_gaussians)
    binding = np.repeat(np.arange(len(faces)), counts)
    u, v = rng.random(n_gaussians), rng.random(n_gaussians)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    pf = p[binding]
    point = pf[:, 0] + u[:, None] * (pf[:, 1] - pf[:, 0]) + v[:, None] * (
        pf[:, 2] - pf[:, 0])
    xyz = np.einsum("gji,gj->gi", rot[binding], point - origin[binding]) / \
        k[binding, None]
    xyz[:, 1] += rng.normal(0.0, st["normal_offset"], n_gaussians)
    turn = rng.uniform(0.0, 2 * np.pi, n_gaussians)
    tilt = rng.normal(0.0, st["tilt"], (n_gaussians, 2))
    quat = np.stack([np.cos(turn / 2), tilt[:, 0], np.sin(turn / 2),
                     tilt[:, 1]], 1)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    jitter = rng.normal(0.0, st["scale_jitter"], (n_gaussians, 3))
    scaling = np.log([st["plane_scale"], st["normal_scale"],
                      st["plane_scale"]]) + jitter
    opacity = rng.normal(st["opacity_logit"], st["opacity_sd"], n_gaussians)
    cen = origin[binding]
    smooth = np.sin(37.0 * cen[:, :1] + np.array([0.0, 1.1, 2.3])) * np.cos(
        23.0 * cen[:, 1:2] + np.array([0.4, 0.0, 1.7]))
    colour = (np.asarray(st["base_colour"]) + 0.1 * smooth
              + rng.normal(0.0, st["colour_sd"], (n_gaussians, 3)))
    dc = ((colour - 0.5) / SH_C0)[:, None, :]
    sd = np.repeat(np.asarray(st["rest_sd"], np.float64), [3, 5, 7])
    rest = rng.standard_normal((n_gaussians, 15, 3)) * sd[None, :, None]
    out = {"binding": binding, "xyz": xyz, "rotation": quat,
           "scaling": scaling, "opacity": opacity, "features_dc": dc,
           "features_rest": rest}
    return {key: (a.astype(np.int64) if a.dtype.kind in "iu"
                  else a.astype(np.float32)) for key, a in out.items()}


def avatar_arrays(cfgf: dict) -> dict:
    """FLAME's stand-ins and the Gaussians on its template."""
    fl = flame_arrays(cfgf)
    return dict(fl, **gaussian_arrays(
        fl["v_template"], fl["faces"], cfgf["sizes"]["n_gaussians"],
        cfgf["avatar_seed"], cfgf["stand_ins"]))


def camera_rig(rig: dict) -> np.ndarray:
    """(n_cameras, 14) float32 [world-to-camera 3 x 4 row-major | fx |
    fy], rows of cameras at rig["pitch"] (degrees, one a row), yaws
    evenly over rig["yaw"]."""
    rows = len(rig["pitch"])
    per_row = rig["n_cameras"] // rows
    target = np.asarray(rig["target"], np.float64)
    out = []
    for pitch in np.radians(rig["pitch"]):
        for yaw in np.radians(np.linspace(*rig["yaw"], per_row)):
            centre = target + rig["distance"] * np.array(
                [np.sin(yaw) * np.cos(pitch), np.sin(pitch),
                 np.cos(yaw) * np.cos(pitch)])
            fwd = (target - centre) / np.linalg.norm(target - centre)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            r = np.stack([right, down, fwd])
            out.append(np.concatenate([np.concatenate(
                [r, -(r @ centre)[:, None]], 1).reshape(-1),
                [rig["focal"], rig["focal"]]]))
    return np.asarray(out, np.float32)
