"""The chained timer the probes share (twin of the `timed` each reference
probe carries, e.g. benchmarks/calib_probe.py:21-39).

A chain is `inner` dependent calls of fn: call k gets
fn(a0 * (1 + carry * 1e-30), *rest), carry being call k-1's scalar *
1e-30 (0 first), kept on the device, so each call waits on the one
before; the chain returns the sum of the calls' scalars. With
`seeded=True` (benchmarks/scatter_probe.py:32-36) the carry goes in as
fn(*args, seed=carry) instead. One chain runs first, printed under the
reference's `[compile Ns]` label (here: the first launches and the
libraries' set-up); then `reps` chains, ended by one host read of the
last one's sum. Seconds a call are the host clock over reps * inner.

The calls are the eager ops the port runs: no CUDA graph and no
torch.compile. So, unlike under the reference's one XLA program, the
perturbation is a full-size elementwise pass of its own, and each call
pays its host launches; calib_probe's intercept and roofline_probe's
empty body print that cost. The perturbed input keeps its dtype (a
0-dim float32 carry does not promote a bfloat16 tensor).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Case:
    tag: str
    seconds: float      # a call, over the timed chains
    compile_s: float    # the first chain
    first: float        # the first chain's sum
    last: float         # the last timed chain's sum


def chain(fn: Callable, args, inner: int, seeded: bool = False):
    """`inner` dependent calls of fn on args: the sum of their scalars,
    on the device, with no host read."""
    a0, rest = args[0], args[1:]
    carry = torch.zeros((), dtype=torch.float32, device=a0.device)
    ss = []
    for _ in range(inner):
        s = (fn(*args, seed=carry) if seeded
             else fn(a0 * (1.0 + carry * 1e-30), *rest))
        carry = s * 1e-30
        ss.append(s)
    return torch.stack(ss).sum()


@torch.no_grad()
def timed(tag: str, fn: Callable, *args, inner: int, reps: int, line: str,
          cases: List[Case], first_line: Optional[str] = None,
          seeded: bool = False) -> float:
    """Times fn on args as above and prints `line`, formatted with tag,
    ms (a call), ct (the first chain's seconds) and b (args[0]'s leading
    size); `first_line`, if given, is printed after the first chain.
    Appends the Case to `cases` and returns seconds a call."""
    t0 = time.perf_counter()
    first = float(chain(fn, args, inner, seeded))
    ct = time.perf_counter() - t0
    if first_line is not None:
        print(first_line.format(tag=tag, ct=ct), flush=True)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = chain(fn, args, inner, seeded)
    last = float(out)
    dt = (time.perf_counter() - t0) / (reps * inner)
    print(line.format(tag=tag, ms=dt * 1e3, ct=ct, b=args[0].shape[0]),
          flush=True)
    cases.append(Case(tag, dt, ct, first, last))
    return dt
