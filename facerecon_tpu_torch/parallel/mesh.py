"""Data parallelism over torch.distributed (twin of
facerecon_tpu/parallel/mesh.py).

The reference shards the batch (or frame) axis over a 1-D device mesh
and lets XLA insert the collectives. Here each rank is one process on
one device: it holds a full copy of the model, takes its contiguous
slice of the global batch, and the collectives are explicit:
  - the gradients are flattened into one buffer and all-reduced once a
    step (`all_reduce_grads`);
  - BatchNorm's moments are all-reduced in its forward (`all_reduce`,
    differentiable, so the backward sees the global statistics;
    models/resnet.py);
  - the tracker's shared coefficients sum their gradients over the
    frames of every rank (track.py).

The model is not wrapped in DistributedDataParallel: its `module.`
prefix would change the checkpoint's layout between world sizes.

Launch with `python -m torch.distributed.run --standalone
--nproc-per-node N -m facerecon_tpu_torch.train ...`; `init` reads the
variables it sets. Backend nccl on cuda (rank r on card LOCAL_RANK),
gloo on the CPU. Without those variables there is no process group and
every function here is the identity of one rank.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from facerecon_tpu_torch import resolve_device


def init(device="cuda", world_size: Optional[int] = None,
         rank: Optional[int] = None,
         init_method: str = "env://") -> torch.device:
    """Join the process group and return this rank's device.

    world_size/rank None: read WORLD_SIZE, RANK and LOCAL_RANK as
    torch.distributed.run sets them; without WORLD_SIZE, no group is
    made (world size 1). Given explicitly (one process a card, rank r on
    card r), a group is made even at world size 1."""
    dev = resolve_device(device)
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return dev
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        local = rank
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method,
                                world_size=world_size, rank=rank)
    return dev


def close() -> None:
    """Leave the process group, if there is one."""
    if grouped():
        dist.destroy_process_group()


def grouped() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if grouped() else 1


def rank() -> int:
    return dist.get_rank() if grouped() else 0


def _slice(x, axis: int):
    if isinstance(x, (tuple, list)):
        return type(x)(_slice(v, axis) for v in x)
    n, w = x.shape[axis], world()
    if w == 1:
        return x
    if n % w:
        raise ValueError(f"axis {axis} of size {n} does not divide over "
                         f"{w} ranks")
    k = n // w
    idx = (slice(None),) * axis + (slice(rank() * k, (rank() + 1) * k),)
    return x[idx]


def shard_batch(x):
    """This rank's contiguous slice of the leading (batch or frame) axis
    of a tensor or array, or of each in a tuple or list. Raises unless
    the axis divides by the world size."""
    return _slice(x, 0)


def shard_axis1(x):
    """shard_batch on axis 1: a (steps, batch, ...) stack keeps its step
    axis whole on each rank."""
    return _slice(x, 1)


def unshard_batch(x: torch.Tensor) -> torch.Tensor:
    """The inverse of shard_batch: every rank's slice, concatenated in
    rank order along the leading axis."""
    if not grouped():
        return x
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def replicate(module_or_tensors):
    """Broadcast from rank 0, in place: a module's parameters and
    buffers, or each tensor of a list or tuple. Returns its argument."""
    if grouped():
        tensors = (list(module_or_tensors.parameters())
                   + list(module_or_tensors.buffers())
                   if isinstance(module_or_tensors, torch.nn.Module)
                   else module_or_tensors)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, 0)
    return module_or_tensors


def all_reduce_grads(params, op: str = "mean") -> None:
    """Sum (op "sum") or average (op "mean") the gradients of `params`
    over the ranks: one all_reduce of one flat buffer, then each
    gradient is copied back. Parameters without a gradient are left
    out (every rank has the same ones)."""
    if not grouped():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    if op == "mean":
        flat /= world()
    elif op != "sum":
        raise ValueError(f"unknown op {op!r}")
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks. Each rank's x feeds every rank's
    y, so dL/dx is the sum over the ranks of dL/dy."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, differentiable: the backward sums
    the incoming gradient over the ranks too."""
    return _AllReduceSum.apply(x) if grouped() else x
