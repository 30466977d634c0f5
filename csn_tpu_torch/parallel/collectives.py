"""Collectives with gradients over a `torch.distributed` group, and joining
the world that the environment describes.

The JAX package writes its multi-device steps as one SPMD program under
`shard_map`, where `psum` and `all_gather` carry their transposes into the
backward pass. Here every rank is a process of its own, so each collective
is a `torch.autograd.Function` whose backward is the forward's transpose:

* `all_reduce` (psum): the backward all-reduces the cotangents.
* `broadcast_from` (`hrnet.py:399-402`'s masked psum): the source rank's
  tensor, every other rank's zeros, all-reduced. One term per entry is
  nonzero, so the sum is exact in any dtype.
* `all_gather`: a zeroed [size, ...] buffer in which rank `index` writes
  slot `index`, all-reduced. The backward all-reduces the cotangent and
  keeps slot `index`: the reduce-scatter that is all_gather's transpose.

All three are all-reduces, the one collective that every backend serves
for every tensor (gloo also for CUDA tensors, so that two ranks can share
one card). Every rank must call the same collectives in the same order,
in the backward pass too: the models keep their autograd graphs the same
on every rank (a rank's role selects values, never code paths).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.nn.functional as F


def join_world(device: str) -> str:
    """Join the `torch.distributed` world that the environment describes
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun sets them):
    NCCL for a CUDA device, one rank per card at `cuda:LOCAL_RANK`; gloo on
    the CPU. Returns this rank's device. A world that is already
    initialised is kept."""
    if str(device).startswith("cuda"):
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        device = f"cuda:{torch.cuda.current_device()}"
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend=backend)
    return device


def world_size() -> int:
    """Ranks of the initialised world; 0 without one."""
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 0


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group` (None: every rank), on
    every rank; differentiable (psum)."""
    return _AllReduce.apply(x, group)


def broadcast_from(x: torch.Tensor, is_source: bool, group=None
                   ) -> torch.Tensor:
    """The source rank's `x` on every rank of `group`, as a masked sum:
    exactly one rank passes `is_source`."""
    keep = torch.tensor(bool(is_source), device=x.device)
    return all_reduce(torch.where(keep, x, torch.zeros_like(x)), group)


def all_gather(x: torch.Tensor, index: int, size: int, group=None
               ) -> torch.Tensor:
    """[size, *x.shape]: slot i holds the `x` of the rank at `index` i of
    `group`; differentiable (its backward is the reduce-scatter)."""
    pad = (0, 0) * x.dim() + (index, size - 1 - index)
    return all_reduce(F.pad(x[None], pad), group)
