"""train: the step of train.make_train_step at one batch, BatchNorm in
train mode; a unit is one step. The first steps, through the same call,
are the warm-up and are judged against the reference's."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import frozen, weights
from perfbench.kinds import (CNN_BELOW, GEO_BELOW, Cell, port_bfm,
                             port_config, port_pipeline)
from perfbench.reference import geometry as refgeo, pipeline as ref


class Kind(Cell):

    train_bn = True

    def setup(self):
        from facerecon_tpu_torch.train import (TrainState, make_optimizer,
                                               make_train_step)
        tr = self.tr
        self.batch = tr["batch"]
        self.unit_faces = self.batch
        self.cfg = port_config(self.cfgf, self.batch)
        self.bfm = port_bfm(self.arrays, self.dev)
        images, _ = frozen.train_inputs(tr["pool"], self.batch, self.size,
                                        self.seed)
        self.images = torch.from_numpy(images).to(self.dev)
        self.lmk = self.face_landmarks(tr["pool"] * self.batch).reshape(
            tr["pool"], self.batch, -1, 2)
        self.reset_peak()
        self.pipe = port_pipeline(self.cfg, self.bfm, self.leaves, self.dev)
        self.pipe.model.train()
        opt, sched = make_optimizer(self.cfg, self.pipe.model.parameters(),
                                    self.cfgf["optimizer"]["total_steps"])
        self.state = TrainState(optimizer=opt, scheduler=sched)
        self.train_step = make_train_step(self.pipe)
        self.k = 0

    def warm(self):
        """The judged first steps are the warm-up."""
        self.readings = self.first_steps(self.tr["judged_steps"])

    def face_landmarks(self, n: int):
        """The 68 projected landmarks of n faces drawn by sample_coeffs
        from the seed: targets a landmark detector could give."""
        c = torch.from_numpy(frozen.sample_coeffs(
            np.random.default_rng([self.seed, 2]), self.sizes, n)).to(
                self.dev)
        with torch.no_grad():
            return torch.cat([refgeo.geometry(c[i:i + 64], self.mesh,
                                              self.cam, self.sizes).landmarks
                              for i in range(0, n, 64)])

    def first_steps(self, n: int):
        """The first n steps through the timed call, on n different
        batches; their losses, the first gradient as Adam holds it, each
        leaf's change after the n, and the coefficients the CNN regressed
        in the first (a hook on the model, removed before the window)."""
        named = dict(self.pipe.model.named_parameters())
        start = {k: p.detach().clone() for k, p in named.items()}
        losses, grads, first = [], {}, []
        b1 = self.cfgf["optimizer"]["b1"]
        hook = self.pipe.model.register_forward_hook(
            lambda _m, _a, out: first.append(out.detach().float().clone()))
        for t in range(n):
            parts = self.step()
            if t == 0:
                hook.remove()
            losses.append({k: float(v) for k, v in parts.items()})
            if t == 0:
                for k, p in named.items():
                    st = self.state.optimizer.state.get(p, {})
                    g = st.get("exp_avg")
                    grads[k] = (0.0 if g is None else float(
                        torch.linalg.vector_norm(g.double()) / (1 - b1)))
        change = {k: float(torch.linalg.vector_norm(
            (p.detach() - start[k]).double())) for k, p in named.items()}
        return ref.TrainReadings(losses, grads, change, first[0])

    def step(self):
        i = self.k % self.images.shape[0]
        parts = self.train_step(self.state, self.images[i], self.lmk[i])
        self.k += 1
        return parts

    def traced(self):
        return self.hook_model(self.pipe.model)

    def outputs(self):
        return self.readings

    def free(self):
        self.pipe = self.state = self.train_step = self.bfm = None

    def batches(self, n):
        return [(self.images[i], self.lmk[i]) for i in range(n)]

    def judge(self, prog):
        from perfbench import check
        return check.judge_train(prog, self.reference(), self.sizes)

    def reference(self, cnn_precision="f32", geo_precision="f32"):
        """The reference's steps from the same leaves (the program loaded
        copies of them) on the same batches."""
        return ref.train(self.leaves, weights.trainable(self.n_coeff),
                         self.batches(self.tr["judged_steps"]), self.mesh,
                         self.cam, self.sizes, self.cfgf["loss"],
                         self.cfgf["optimizer"], cnn_precision,
                         geo_precision)

    def control(self):
        return self.reference(CNN_BELOW, GEO_BELOW)
