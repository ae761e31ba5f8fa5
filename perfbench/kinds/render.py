"""render: ops/render.render_coeffs(inference=True) over resident
coefficients in microbatches, no CNN; a unit is one pass over the
batch."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import frozen
from perfbench.kinds import GEO_BELOW, port_bfm, port_config, render_outputs
from perfbench.kinds.reconstruct import Kind as Reconstruct
from perfbench.reference import pipeline as ref


class Kind(Reconstruct):

    cnn = False

    def setup(self):
        tr = self.tr
        self.batch, self.micro = tr["batch"], tr["microbatch"]
        self.cfg = port_config(self.cfgf, self.batch)
        self.bfm = port_bfm(self.arrays, self.dev)
        self.images = None
        self.coeffs = torch.from_numpy(frozen.sample_coeffs(
            np.random.default_rng(self.seed), self.sizes, self.batch)).to(
                self.dev)
        self.unit_faces = self.batch
        self.reset_peak()

    def step(self):
        from facerecon_tpu_torch.ops.render import render_coeffs
        from facerecon_tpu_torch.utils.coeffs import split_coeff
        outs = []
        with torch.no_grad():
            for c in self.coeffs.split(self.micro):
                outs.append((c, render_coeffs(split_coeff(c, self.cfg),
                                              self.bfm, self.cfg,
                                              inference=True)))
        self.last = outs

    def traced(self):
        self.captured.extend(self.coeffs.split(self.micro))
        return []

    def free(self):
        self.bfm = self.last = None

    def judge(self, prog):
        from perfbench import check
        return check.judge_render(prog, self.mesh, self.cam, self.sizes)

    def control(self):
        with torch.no_grad():
            return render_outputs([(c, ref.render(
                c, self.mesh, self.cam, self.sizes, precision=GEO_BELOW))
                for c in self.coeffs.split(16)])
