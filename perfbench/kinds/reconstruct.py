"""reconstruct: Pipeline.reconstruct(inference=True) over a resident batch
of images in microbatches, the BatchNorm regressor folded by the
program's fuse_for_inference; a unit is one pass over the batch."""

from __future__ import annotations

import torch

from perfbench import frozen
from perfbench.kinds import (CNN_BELOW, GEO_BELOW, Cell, port_bfm,
                             port_config, port_pipeline, render_outputs,
                             sync)
from perfbench.reference import cnn, pipeline as ref


class Kind(Cell):

    def setup(self):
        from facerecon_tpu_torch.pipeline import fuse_for_inference
        tr = self.tr
        self.batch, self.micro = tr["batch"], tr["microbatch"]
        self.cfg = port_config(self.cfgf, self.batch)
        self.bfm = port_bfm(self.arrays, self.dev)
        self.images = torch.from_numpy(frozen.headline_images(
            self.batch, self.size, self.seed)).to(self.dev)
        self.reset_peak()
        self.pipe = fuse_for_inference(port_pipeline(
            self.cfg, self.bfm, self.leaves, self.dev))
        self.unit_faces = self.batch

    def warm(self):
        """One unit at the cell's shapes (the first run in a checkout
        builds the kernels here)."""
        self.step()
        sync(self.dev)

    def step(self):
        outs = []
        for im in self.images.split(self.micro):
            cv, _, out = self.pipe.reconstruct(im, inference=True)
            outs.append((cv, out))
        self.last = outs

    def traced(self):
        return self.hook_model(self.pipe.model)

    def outputs(self) -> dict:
        return render_outputs([(cv, o.geometry.verts_world,
                                o.geometry.landmarks2d, o)
                               for cv, o in self.last])

    def free(self):
        self.pipe = self.bfm = self.last = None

    def judge(self, prog):
        from perfbench import check
        return check.judge_render(prog, self.mesh, self.cam, self.sizes,
                                  self.leaves, self.images, self.images)

    def control(self):
        """The reference in the program's place, one precision below the
        configuration's (the CNN in float8, the matmuls in TF32)."""
        outs = []
        with torch.no_grad():
            for i in range(0, self.batch, 16):
                im = self.images[i:i + 16]
                c = cnn.regress(self.leaves, im, False, CNN_BELOW)
                outs.append((c, ref.render(c, self.mesh, self.cam,
                                           self.sizes, background=im,
                                           precision=GEO_BELOW)))
        return render_outputs(outs)
