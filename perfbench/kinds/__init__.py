"""What every kind of cell shares. A kind is the entry point a cell
drives: the traffic file names it (`"kind"`), and kinds/<kind>.py holds
its class `Kind`, found by that name (spec.kind), so a cell that drives
a new entry point brings a file of its own. A Kind builds the program
under test from the benchmark's inputs, runs one timed unit at a time,
and hands over what it produced for the comparison:

  reconstruct  Pipeline.reconstruct(inference=True) over a resident batch
               in microbatches (the BatchNorm regressor folded by the
               program's fuse_for_inference); a unit is one pass
  render       ops/render.render_coeffs(inference=True) over resident
               coefficients in microbatches; a unit is one pass
  train        train.make_train_step at one batch; a unit is one step
  frame        reconstruct at batch 1 on a host frame, the coefficients,
               landmarks and image copied back; a unit is one request

A Kind has setup(), warm(), step(), traced() (the hooks of a traced
stretch), outputs(), free(), judge(outputs) and control() (the
reference in the program's place one precision below), and the
attributes cnn, unit_faces and, for a latency cell, latency.

A batch cell's units are not synchronised one by one: the host enqueues
unit after unit, as an offline pipeline does, and the window ends with
one synchronisation of the device, so it holds all the work enqueued.

Only the kinds and run.py touch the program (facerecon_tpu_torch)."""

from __future__ import annotations

import json
import time

import torch

from perfbench import frozen, weights
from perfbench import reference
from perfbench.reference import cnn, geometry as refgeo


# the control's precisions, one below the configuration's bf16 CNN and
# float32 matmuls
CNN_BELOW = "fp8"
GEO_BELOW = "tf32"


def render_outputs(items) -> dict:
    """[(coefficients, a reference Render)] or [(coefficients, verts,
    landmarks, the program's RenderOut)] -> the judged outputs."""
    if len(items[0]) == 2:
        items = [(c, r.geometry.verts, r.geometry.landmarks, r)
                 for c, r in items]
    return {"coeff": torch.cat([i[0] for i in items]),
            "verts": torch.cat([i[1] for i in items]),
            "landmarks": torch.cat([i[2] for i in items]),
            "image": torch.cat([i[3].image for i in items]),
            "tri_id": torch.cat([i[3].tri_id for i in items])}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


_MESHES: dict = {}


def mesh_arrays(cfgf: dict) -> dict:
    """The configuration's mesh (made once a process: it does not depend
    on the run's seed)."""
    key = json.dumps([cfgf["sizes"], cfgf["mesh_seed"]], sort_keys=True)
    if key not in _MESHES:
        _MESHES[key] = frozen.synthetic_mesh(cfgf["sizes"],
                                             cfgf["mesh_seed"])
    return _MESHES[key]


def port_config(cfgf: dict, batch: int):
    from facerecon_tpu_torch.config import FaceReconConfig
    kw = dict(cfgf["sizes"], **cfgf["camera"], **cfgf["raster"],
              **cfgf.get("loss", {}))
    if "optimizer" in cfgf:
        kw["learning_rate"] = cfgf["optimizer"]["lr"]
    return FaceReconConfig(batch_size=batch, **kw)


def port_bfm(arrays: dict, dev):
    """The program's asset pack from the benchmark's arrays; the program
    derives its own adjacency tables and raster row order."""
    from facerecon_tpu_torch.ops.geometry import device_bfm
    from facerecon_tpu_torch.utils import bfm as pb
    adj, corner_adj, face_slot = pb.vertex_face_adjacency(
        arrays["faces"], arrays["mean_shape"].shape[0] // 3,
        with_corners=True)
    rows, row_id = pb.raster_row_order(arrays["faces"],
                                       arrays["mean_shape"])
    assets = pb.BFMAssets(**arrays, vertex_face_adj=adj,
                          vertex_corner_adj=corner_adj,
                          face_adj_slot=face_slot, raster_rows=rows,
                          raster_row_id=row_id)
    return device_bfm(assets, dev)


def port_pipeline(cfg, bfm, leaves: dict, dev, dtype=torch.bfloat16):
    """The program's BatchNorm regressor holding the benchmark's leaves,
    in a Pipeline with TF32 off (as the program's own constructors set
    it)."""
    from facerecon_tpu_torch.models.resnet import build_model
    from facerecon_tpu_torch.pipeline import Pipeline
    reference.strict()
    with torch.device(dev):
        model = build_model(cfg, 50, dtype)
    model.load_state_dict(leaves)
    model = model.to(dev, memory_format=torch.channels_last)
    return Pipeline(cfg=cfg, bfm=bfm, model=model, device=dev)


class Cell:
    """Shared set-up: the configuration, the mesh, the leaves (where the
    cell runs the CNN) and the reference's view of them."""

    cnn = True
    train_bn = False
    unit_faces = 1

    def __init__(self, spec: dict, seed: int, dev: torch.device):
        # numpy's generators take no negative seed
        self.seed, self.dev = int(seed) % (1 << 64), dev
        reference.strict()
        t = time.perf_counter()
        self.cfgf = spec["config_file"]
        self.tr = spec["traffic"]
        self.sizes = self.cfgf["sizes"]
        self.cam = self.cfgf["camera"]
        self.size = self.cam["image_size"]
        self.arrays = mesh_arrays(self.cfgf)
        self.phases = {"mesh": time.perf_counter() - t}
        t = time.perf_counter()
        self.n_vertices = self.arrays["mean_shape"].shape[0] // 3
        self.mesh = refgeo.mesh_on(self.arrays, dev)
        self.n_coeff = frozen.n_coeff(self.sizes)
        self.leaves = None
        self.captured = []
        if self.cnn:
            self.leaves = weights.make_leaves(self.n_coeff, self.seed, dev,
                                              self.cfgf["init"])
            calib = torch.from_numpy(frozen.headline_images(
                self.tr["calibration_batch"], self.size,
                seed=[self.seed, 1])).to(dev)
            with torch.no_grad():
                feats = cnn.features(self.leaves, calib, self.train_bn)
            weights.calibrate_head(self.leaves, feats, self.sizes)
            del calib, feats
        sync(dev)
        self.phases["leaves"] = time.perf_counter() - t

    # the program's coefficients of each traced unit, for the work counts
    def hook_model(self, model):
        def pre(_mod, _args):
            rf = torch.autograd.profiler.record_function("cnn")
            rf.__enter__()
            self._open = rf

        def post(_mod, _args, out):
            self._open.__exit__(None, None, None)
            self.captured.append(out.detach().clone())
        return [model.register_forward_pre_hook(pre),
                model.register_forward_hook(post)]

    def reset_peak(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
