"""Readings that set the limits of the comparison, on the chip, in one
process (the kernels build once):

  python3 -m perfbench.control --workload <cell> --seeds 11,12,... \
      --control-seeds 21,22,23 [--faults half_batch] \
      [--fault-seeds 21,22,23] [--seconds 2]

For each of --seeds, a run of the cell as run.py makes it (set-up, a
window of --seconds, the comparison): the program's numbers, the lower
readings. For each of --control-seeds, the control: the reference in
the program's place one precision below the configuration's (the CNN
in float8 e4m3, every matmul in TF32), judged the same way. For each of
--fault-seeds (by default the control seeds), each fault of --faults
(faults.py) planted in the program. One JSON line a
reading, on standard output and appended to --out."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from perfbench import check, faults, spec as specs
from perfbench.run import run_cell


def emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def control_numbers(cell, seed, dev):
    kind = specs.kind(cell)(cell, seed, dev)
    kind.setup()
    prog = kind.control()
    kind.free()
    return kind.judge(prog)


def train_detail(cell, seed, dev) -> dict:
    """A training cell's raw readings on one seed: the program's first
    steps, the reference's and the control's (losses by part, each
    leaf's first-gradient and change norms) and each leaf's size."""
    kind = specs.kind(cell)(cell, seed, dev)
    kind.setup()
    kind.warm()
    prog = kind.outputs()
    sizes = {k: p.numel() for k, p in kind.pipe.model.named_parameters()}
    kind.free()
    torch.cuda.empty_cache()
    refr = kind.reference()
    ctrl = kind.control()
    out = {"sizes": sizes,
           "numbers": check.judge_train(prog, refr, kind.sizes),
           "control_numbers": check.judge_train(ctrl, refr, kind.sizes)}
    keep = check.kept_leaves(refr)
    for side, r in (("program", prog), ("control", ctrl)):
        g = check.leaf_gaps(r.grad_norms, refr.grad_norms)
        c = check.leaf_gaps(r.change_norms, refr.change_norms, keep)
        wg, wc = max(g, key=g.get), max(c, key=c.get)
        out[side + "_worst"] = {"grad": [wg, g[wg]], "change": [wc, c[wc]]}
    for side, r in (("program", prog), ("reference", refr),
                    ("control", ctrl)):
        out[side] = dict(r._asdict(), coeff=None)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    p.add_argument("--detail-seeds", default="")
    a = p.parse_args(argv)
    cell = specs.cell(a.workload)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    cseeds = [int(s) for s in a.control_seeds.split(",") if s]
    for seed in [int(s) for s in a.detail_seeds.split(",") if s]:
        emit(a.out, {"cell": a.workload, "side": "detail", "seed": seed,
                     **train_detail(cell, seed, dev)})
    for seed in seeds:
        t = time.perf_counter()
        r = run_cell(cell, seed, a.seconds, False, dev,
                     t_start=time.perf_counter())
        emit(a.out, {"cell": a.workload, "side": "program", "seed": seed,
                     "numbers": {k: v["value"]
                                 for k, v in r["compared"].items()},
                     "metrics": {k: v["value"]
                                 for k, v in r["metrics"].items()},
                     "correct": r["correct"], "peak": r["device"][
                         "memory_peak_bytes"],
                     "seconds": time.perf_counter() - t})
    fseeds = ([int(s) for s in a.fault_seeds.split(",") if s]
              if a.fault_seeds else cseeds)
    for seed in cseeds:
        t = time.perf_counter()
        numbers = control_numbers(cell, seed, dev)
        emit(a.out, {"cell": a.workload, "side": "control", "seed": seed,
                     "numbers": numbers,
                     "correct": check.verdict(
                         numbers, cell["traffic"]["limits"])[0],
                     "seconds": time.perf_counter() - t})
        torch.cuda.empty_cache()
    for seed in fseeds:
        for name in [f for f in a.faults.split(",") if f]:
            t = time.perf_counter()
            r = run_cell(cell, seed, a.seconds, False, dev,
                         fault=faults.FAULTS[name],
                         t_start=time.perf_counter())
            emit(a.out, {"cell": a.workload, "side": name, "seed": seed,
                         "numbers": {k: v["value"]
                                     for k, v in r["compared"].items()},
                         "correct": r["correct"],
                         "seconds": time.perf_counter() - t})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
