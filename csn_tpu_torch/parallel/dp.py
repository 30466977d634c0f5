"""Data parallelism over the ranks of a `torch.distributed` world.

Counterpart of `csn_tpu/parallel/dp.py`. The JAX package shards a stacked
batch over a `data` mesh axis with `shard_map`; here each rank is a process
that builds and holds its own `VoxelBatch` (kernel maps stay rank-local, so
the conv path has no collective) and runs the full model on it. What the
JAX step `pmean`s is averaged with explicit all-reduces:

* the gradients, once per optimizer step (`reduce_grads`, after any
  `iter_size` accumulation; JAX averages each micro-step's gradients,
  which is the same sum);
* the BatchNorm running statistics after every forward in train mode
  (each rank updates them from its own batch, then the world's mean is
  kept: not `DistributedDataParallel`'s broadcast from rank 0);
* the loss.

Every rank then takes the same optimizer step on the same averaged
gradients, so the parameters stay bitwise equal across ranks. Eval outputs
stay on their rank; the trainer gathers the losses and predictions.

`sharded_retrieval_measure` builds the shape graph with the key
descriptors sharded over the ranks and the query blocks replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from csn_tpu_torch.core.interp import interp_batch
from csn_tpu_torch.parallel import collectives
from csn_tpu_torch.parallel.midfc import fold_seed
from csn_tpu_torch.retrieval.graph import retrieval_measure
from csn_tpu_torch.train import steps


@dataclasses.dataclass
class DPWorld:
    """This rank's place in a data-parallel group (`make_mesh`'s mesh):
    `size` ranks, this one at `rank`; its tensors on `device`; `group`
    None for every rank of the world."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's `x`, in rank order."""
        return collectives.all_gather(x, self.rank, self.size, self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.all_reduce(x, self.group) / self.size

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def make_dp_world(n_ranks: int, device) -> DPWorld:
    """The initialised world as a data-parallel group of `n_ranks`."""
    have = collectives.world_size()
    if have != n_ranks:
        raise ValueError(
            f"need an initialised torch.distributed world of {n_ranks} "
            f"ranks for data parallelism, have {have} (start one process "
            f"per rank, e.g. torchrun --nproc_per_node {n_ranks}, and call "
            f"torch.distributed.init_process_group in each)")
    return DPWorld(n_ranks, dist.get_rank(), torch.device(device))


def rank_generator(seed: int, rank: int) -> torch.Generator:
    """The CPU generator of a rank's attention-dropout seeds: `seed` at
    rank 0 (a world of one draws what the single-device trainer draws), a
    folded stream elsewhere (`jax.random.split` / `fold_in` in JAX)."""
    return torch.Generator().manual_seed(
        int(seed) if rank == 0 else fold_seed(seed, rank))


@torch.no_grad()
def average_(tensors: Sequence[torch.Tensor], world: DPWorld,
             divisor: Optional[float] = None) -> None:
    """Replace each tensor, in place, by its sum over the world divided by
    `divisor` (default: the world's size): one all-reduce per dtype of one
    flat buffer, copied back by one multi-tensor copy (not a launch per
    tensor)."""
    divisor = world.size if divisor is None else divisor
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flatten_dense_tensors(group)
        dist.all_reduce(flat, group=world.group)
        flat /= divisor
        torch._foreach_copy_(group, list(_unflatten_dense_tensors(flat,
                                                                  group)))


def average_grads(model, world: DPWorld,
                  divisor: Optional[float] = None) -> None:
    """The accumulated `.grad` of every parameter, averaged over the world.
    Every rank's graph reaches the same parameters, so the set is the same
    on every rank."""
    average_([p.grad for p in model.parameters() if p.grad is not None],
             world, divisor)


def average_buffers(model, world: DPWorld) -> None:
    """The BatchNorm running statistics (the models' only floating-point
    buffers), averaged over the world: `pmean(new_stats)`."""
    average_([b for b in model.buffers() if b.is_floating_point()], world)


@dataclasses.dataclass
class DPTrainerSteps:
    """The trainer's data-parallel steps (`make_dp_trainer_steps`)."""

    # (qb, keys, generator) -> (loss averaged over the world, pred [B, P]
    # of this rank); adds this rank's gradients to `.grad`
    grad_step: Callable
    # () -> None: `.grad` averaged over the world, once per optimizer step
    reduce_grads: Callable
    # (qb, keys) -> (loss [n], point_logits [B, P, C] of this rank,
    # pred [n, B, P])
    eval_step: Callable
    # (qb) -> SSA features [n, B, L0, d] f32
    ssa_step: Callable


def make_dp_trainer_steps(model, world: DPWorld, *,
                          ignore_label: int = 255) -> DPTrainerSteps:
    """Slot-in replacements for the single-device steps of `train/steps.py`
    (`make_dp_trainer_steps`, `csn_tpu/parallel/dp.py:210`)."""

    def grad_step(qb, keys, generator):
        loss, pred = steps.grad_step(model, qb, keys, generator,
                                     ignore_label)
        average_buffers(model, world)
        return world.mean(loss), pred

    def reduce_grads():
        average_grads(model, world)

    @torch.no_grad()
    def eval_step(qb, keys):
        loss, point_logits, pred = steps.eval_step(model, qb, keys,
                                                   ignore_label)
        return world.gather(loss), point_logits, world.gather(pred)

    @torch.no_grad()
    def ssa_step(qb):
        model.eval()
        return world.gather(model(qb, return_ssa=True))

    return DPTrainerSteps(grad_step, reduce_grads, eval_step, ssa_step)


def make_dp_train_step(model, optimizer, world: DPWorld, *,
                       ignore_label: int = 255) -> Callable:
    """(qb, keys, generator, lr=None) -> (loss, pred [B, P]): one
    data-parallel optimizer step on this rank's batch
    (`csn_tpu/parallel/dp.py:103`)."""
    dp = make_dp_trainer_steps(model, world, ignore_label=ignore_label)

    def step(qb, keys, generator, lr=None):
        optimizer.zero_grad(set_to_none=True)
        loss, pred = dp.grad_step(qb, keys, generator)
        dp.reduce_grads()
        if lr is not None:
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
        return loss, pred

    return step


def make_dp_eval_step(model, world: DPWorld) -> Callable:
    """(qb, keys) -> point logits [n, B, P, C] of every rank's batch
    (`csn_tpu/parallel/dp.py:176`)."""

    @torch.no_grad()
    def step(qb, keys=()):
        model.eval()
        return world.gather(interp_batch(model(qb, keys), qb))

    return step


@torch.no_grad()
def sharded_retrieval_measure(q_feats, q_mask, k_feats, k_mask,
                              world: DPWorld, key_chunk: int = 8,
                              query_block: int = 4) -> np.ndarray:
    """The [N_q, N_k] mean-of-max cosine measure with the KEY descriptors
    sharded over the world (`csn_tpu/parallel/dp.py:305`): the keys are
    zero-padded to a multiple of the world (padding masked), each rank
    measures every query against its N_k / n keys (`retrieval_measure`,
    whose blocks are `_retrieval_block`), and the column slices are
    gathered; the padding columns are cut off. Every rank returns the
    full matrix."""
    n = world.size
    nk = k_feats.shape[0]
    per = -(-nk // n)
    pad = per * n - nk
    kf = np.pad(np.asarray(k_feats), ((0, pad), (0, 0), (0, 0)))
    km = np.pad(np.asarray(k_mask, dtype=bool), ((0, pad), (0, 0)))
    lo = world.rank * per
    cols = retrieval_measure(q_feats, q_mask, kf[lo:lo + per],
                             km[lo:lo + per], query_block=query_block,
                             key_chunk=key_chunk, device=world.device)
    parts = world.gather(torch.from_numpy(cols).to(world.device))
    full = parts.permute(1, 0, 2).reshape(cols.shape[0], n * per)
    return full[:, :nk].cpu().numpy()
