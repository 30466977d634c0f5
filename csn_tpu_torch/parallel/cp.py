"""Collection parallelism: the [self]+K shape collection sharded over the
ranks of a `torch.distributed` world laid out as a ('data', 'col') grid.

Counterpart of `csn_tpu/parallel/cp.py`. The CSN step's cost is linear in
K (the combined (K+1)*B backbone pass), and the members of the collection
are independent until the small cross-shape head. Rank r sits at data
index r // (K+1) and col index r % (K+1): col 0 holds the query batch of
its data shard, col k its k-th neighbour batch, and each rank runs backbone
+ SSA on its member alone. `HRNetSimCSN.cp_forward` stitches the head
together over the col group.

The loss keeps the JAX semantics: only col 0 seeds its cross entropy and a
key rank contributes 0 * its own; every rank calls `backward()`, so the
collectives of the backward pass meet on every rank and route the query's
cotangent through each key rank's cross attention and backbone. The
gradients are summed over col and averaged over data (one all-reduce over
the world, divided by n_data); the BatchNorm statistics are averaged over
both. Train-mode BatchNorm normalises each member with its own statistics,
where the single-device combined pass uses joint query + key statistics:
the approximation data parallelism makes across the batch. Instance and
layer norms, and eval mode, are exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from csn_tpu_torch.core.interp import interp_batch
from csn_tpu_torch.parallel import collectives
from csn_tpu_torch.parallel.dp import DPWorld, average_buffers, average_grads
from csn_tpu_torch.train.losses import cross_entropy_ignore, predict_nonzero


@dataclasses.dataclass
class CPGrid:
    """This rank's place in the ('data', 'col') grid, and its groups."""

    n_data: int
    n_col: int
    data_index: int
    col_index: int
    col_group: Optional[object]    # the ranks of this rank's data shard
    world: DPWorld                 # every rank, for the gradient sums


def make_cp_grid(n_data: int, n_col: int, device) -> CPGrid:
    """The initialised world as an (n_data, n_col) grid (`make_cp_mesh`)."""
    need = n_data * n_col
    have = collectives.world_size()
    if have != need:
        raise ValueError(
            f"need an initialised torch.distributed world of {need} ranks "
            f"({n_data}x{n_col} grid), have {have} (start one process per "
            f"rank and call torch.distributed.init_process_group in each)")
    rank = dist.get_rank()
    d, c = divmod(rank, n_col)
    mine = None
    for di in range(n_data):   # every rank takes part in every new_group
        g = dist.new_group(ranks=[di * n_col + ci for ci in range(n_col)])
        if di == d:
            mine = g
    return CPGrid(n_data, n_col, d, c, mine,
                  DPWorld(need, rank, torch.device(device)))


@dataclasses.dataclass
class CPTrainerSteps:
    """The collection-parallel steps (`make_cp_trainer_steps`)."""

    # (lb, generator) -> (loss, pred [B, P] of this data shard's query);
    # adds this rank's gradients to `.grad`
    grad_step: Callable
    # () -> None: `.grad` summed over col, averaged over data
    reduce_grads: Callable
    # (lb) -> (loss, point_logits [B, P, C], pred [B, P]) of this data
    # shard's query
    eval_step: Callable


def make_cp_trainer_steps(model, grid: CPGrid, *, k_neighbors: int,
                          ignore_label: int = 255) -> CPTrainerSteps:
    """Collection-parallel train / eval steps over `grid`
    (`csn_tpu/parallel/cp.py:246`)."""
    if k_neighbors < 1:
        raise ValueError("collection parallelism needs k_neighbors >= 1")
    if grid.n_col != k_neighbors + 1:
        raise ValueError(
            f"col mesh axis ({grid.n_col}) must equal k_neighbors+1 "
            f"({k_neighbors + 1}): one rank per collection member")
    is_q = grid.col_index == 0

    def local_loss(lb, generator):
        """(masked, point logits): `masked` is col 0's query cross entropy,
        and 0 * its own cross entropy on a key rank: the value that is
        differentiated, and summed over the world for the loss."""
        out = model.cp_forward(lb, grid.col_index, grid.n_col,
                               grid.col_group, generator)
        point_logits = interp_batch(out, lb)
        ce = cross_entropy_ignore(point_logits, lb.labels, ignore_label,
                                  lb.point_mask)
        return ce * (1.0 if is_q else 0.0), point_logits

    def world_loss(masked):
        """The mean over data shards of col 0's cross entropy."""
        return collectives.all_reduce(masked.detach(),
                                      grid.world.group) / grid.n_data

    def from_query(x):
        """Col 0's `x` on every rank of the col group."""
        return collectives.broadcast_from(x.detach(), is_q, grid.col_group)

    def grad_step(lb, generator):
        model.train()
        masked, point_logits = local_loss(lb, generator)
        masked.backward()
        average_buffers(model, grid.world)
        with torch.no_grad():
            return world_loss(masked), from_query(
                predict_nonzero(point_logits))

    def reduce_grads():
        average_grads(model, grid.world, divisor=grid.n_data)

    @torch.no_grad()
    def eval_step(lb):
        model.eval()
        masked, point_logits = local_loss(lb, None)
        return (world_loss(masked), from_query(point_logits),
                from_query(predict_nonzero(point_logits)))

    return CPTrainerSteps(grad_step, reduce_grads, eval_step)
