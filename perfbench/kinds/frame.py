"""frame: one client, closed loop, batch 1: each request is a host
float32 frame copied in, run through Pipeline.reconstruct(inference=True),
its coefficients, landmarks and image copied back; a unit is one
request, timed from the call until its results are on the host."""

from __future__ import annotations

import random
import time

import torch

from perfbench import frozen
from perfbench.kinds import (CNN_BELOW, GEO_BELOW, port_bfm, port_config,
                             port_pipeline)
from perfbench.kinds.reconstruct import Kind as Reconstruct
from perfbench.reference import cnn, pipeline as ref


class Kind(Reconstruct):

    def setup(self):
        from facerecon_tpu_torch.pipeline import fuse_for_inference
        tr = self.tr
        self.cfg = port_config(self.cfgf, 1)
        self.bfm = port_bfm(self.arrays, self.dev)
        self.frames = frozen.headline_images(tr["frames"], self.size,
                                             self.seed)
        self.reset_peak()
        self.pipe = fuse_for_inference(port_pipeline(
            self.cfg, self.bfm, self.leaves, self.dev))
        self.n = 0
        self.latency = []
        self.sample = {}
        self.rng = random.Random(self.seed)
        self.keep = tr["sample"]

    def warm(self):
        for _ in range(self.tr["warmup_requests"]):
            self.request(self.frames[0])

    def request(self, frame):
        cv, _, out = self.pipe.reconstruct(frame[None], inference=True)
        return (cv.cpu(), out.geometry.landmarks2d.cpu(), out.image.cpu())

    def step(self):
        k = self.n % len(self.frames)
        t0 = time.perf_counter()
        res = self.request(self.frames[k])
        self.latency.append(time.perf_counter() - t0)
        # a reservoir sample of the requests, drawn from the seed
        if len(self.sample) < self.keep:
            self.sample[self.n] = (k, res)
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.keep:
                self.sample.pop(sorted(self.sample)[j])
                self.sample[self.n] = (k, res)
        self.n += 1

    def outputs(self) -> dict:
        items = [self.sample[i] for i in sorted(self.sample)]
        self.judged_frames = [k for k, _ in items]
        return {"coeff": torch.cat([r[0] for _, r in items]).to(self.dev),
                "landmarks": torch.cat([r[1] for _, r in items]),
                "image": torch.cat([r[2] for _, r in items])}

    def judge(self, prog):
        from perfbench import check
        imgs = torch.from_numpy(self.frames[self.judged_frames]).to(self.dev)
        return check.judge_render(prog, self.mesh, self.cam, self.sizes,
                                  self.leaves, imgs, imgs)

    def control(self):
        self.judged_frames = list(range(min(self.keep, len(self.frames))))
        im = torch.from_numpy(self.frames[self.judged_frames]).to(self.dev)
        with torch.no_grad():
            c = cnn.regress(self.leaves, im, False, CNN_BELOW)
            r = ref.render(c, self.mesh, self.cam, self.sizes,
                           background=im, precision=GEO_BELOW)
        return {"coeff": c, "landmarks": r.geometry.landmarks,
                "image": r.image}
