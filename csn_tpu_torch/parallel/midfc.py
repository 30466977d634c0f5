"""MID-FC multi-rank parallelism: data-parallel batches x sequence-parallel
point shards over the ranks of a `torch.distributed` world laid out as a
('data', 'seq') grid.

Counterpart of `csn_tpu/parallel/midfc.py`. The reference's 20 x 500
attention chunking makes the 10000-point axis parallel across ranks:
block-diagonal attention lets each rank hold P / n_seq points of the query
AND of every neighbor and run the CSA stack on its slice; only the
mean-pooled compatibility descriptors cross ranks (one all-reduce of [B, d]
per pooled shape). The 'data' axis shards the batch. Rank r sits at data
index r // n_seq and seq index r % n_seq.

chunk_size=None (full attention) stays exact under 'seq' sharding too: the
MHA core becomes a ring over the seq group (ops/attention.py): K/V blocks
hop around the ring with online-softmax accumulation, so every query attends
the global point set.

Exactness: the sharded loss all-reduces (nll_sum, valid_count) and divides
once, reproducing the single-device masked mean however the positive labels
distribute over shards; gradients are all-reduced and divided by the same
count; pooled descriptors average equal-size local means. Gradients
therefore match the single-device step (at dropout 0; with dropout the
streams are folded by rank, except that a ring's ranks share the
attention-dropout seed, whose mask is keyed by absolute position).

Every rank calls a step with the SAME global batch and seed, slices its
part, and returns the same global result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from csn_tpu_torch.train.losses import cross_entropy_positive_sum

@dataclasses.dataclass
class MidfcGrid:
    """This rank's place in the ('data', 'seq') grid and its seq group."""

    n_data: int
    n_seq: int
    data_index: int
    seq_index: int
    seq_group: Optional[object]   # ranks sharing this rank's data index


def make_midfc_grid(n_data: int = 1, n_seq: int = 1) -> MidfcGrid:
    need = n_data * n_seq
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(
            f"need an initialised torch.distributed world of {need} ranks "
            f"for a ({n_data},{n_seq}) grid, have {have} (start one process "
            f"per rank and call torch.distributed.init_process_group in "
            f"each)")
    rank = dist.get_rank()
    d, s = divmod(rank, n_seq)
    mine = None
    # every rank takes part in the creation of every group
    for di in range(n_data):
        g = dist.new_group(ranks=[di * n_seq + si for si in range(n_seq)])
        if di == d:
            mine = g
    return MidfcGrid(n_data, n_seq, d, s, mine)


@dataclasses.dataclass
class MidfcParallelSteps:
    """Slot-in replacements for MidfcRunner's single-device steps (same
    signatures; `neighbors` is None on the SSA surfaces)."""

    grad: Callable      # (feats, labels, neighbors, seed) -> (loss, grads)
    eval: Callable      # (feats, neighbors) -> logits [B, P, C]
    ssa_feats: Callable  # (feats) -> [B, P, d]


def _check_shapes(grid: MidfcGrid, feats, chunk_size: Optional[int]):
    b, p = feats.shape[0], feats.shape[1]
    if b % grid.n_data:
        raise ValueError(
            f"batch {b} not divisible by data axis {grid.n_data}")
    if p % grid.n_seq:
        raise ValueError(f"points {p} not divisible by seq axis {grid.n_seq}")
    if chunk_size is not None and (p // grid.n_seq) % chunk_size:
        raise ValueError(
            f"local points {p // grid.n_seq} not divisible by chunk_size "
            f"{chunk_size}; pick n_seq so P/n_seq is a chunk multiple")


def fold_seed(seed: int, index: int) -> int:
    """A distinct 62-bit seed per (seed, index): one dropout stream a rank."""
    return (int(seed) * 1000003 + index + 1) % (2 ** 62)


def make_midfc_steps(runner, n_data: int, n_seq: int) -> MidfcParallelSteps:
    """Sharded grad / eval / ssa-feature steps for a `MidfcRunner`. The
    runner's module is made seq-aware in place (same parameters) when the
    grid has a non-trivial 'seq' extent, or when it computes full attention
    (`chunk_size=None`): that is a ring over the seq group whatever the
    group's size, a ring of one rank at n_seq = 1."""
    grid = make_midfc_grid(n_data, n_seq)
    model = runner.model
    is_csa = runner.attention_type == "csa"
    chunk = model.chunk_size
    ring = chunk is None
    if grid.n_seq > 1 or ring:
        model.shard_points(grid.seq_group)
    world = grid.n_data * grid.n_seq

    def all_reduce(x):
        if world > 1:   # a world of one rank has nothing to add
            dist.all_reduce(x)

    def local(x, point_axis):
        """This rank's slice of a global array: batch rows of its data index,
        points of its seq index."""
        if x is None:
            return None
        x = np.asarray(x)
        bl = x.shape[0] // grid.n_data
        pl = x.shape[point_axis] // grid.n_seq
        x = x[grid.data_index * bl:(grid.data_index + 1) * bl]
        sl = [slice(None)] * x.ndim
        sl[point_axis] = slice(grid.seq_index * pl, (grid.seq_index + 1) * pl)
        return runner._dev(np.ascontiguousarray(x[tuple(sl)]))

    def gather(x):
        """Local [B/n_data, P/n_seq, C] -> global [B, P, C] on every rank."""
        if world == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        rows = [torch.cat(parts[d * grid.n_seq:(d + 1) * grid.n_seq], dim=1)
                for d in range(grid.n_data)]
        return torch.cat(rows, dim=0)

    def grad_step(feats, labels, neighbors, seed):
        _check_shapes(grid, feats, chunk)
        if not is_csa and neighbors is not None:
            raise ValueError("the SSA step takes no neighbors")
        model.train()
        model.zero_grad(set_to_none=True)
        # a ring's ranks share the attention seed (absolute-position mask);
        # otherwise every rank folds its own stream
        index = grid.data_index if ring else \
            grid.data_index * grid.n_seq + grid.seq_index
        gen = torch.Generator().manual_seed(fold_seed(seed, index))
        logits = runner._call_model(local(feats, 1), local(neighbors, 2),
                                    gen)
        s, n = cross_entropy_positive_sum(logits, local(labels, 1))
        s.backward()
        s = s.detach()
        n = n.to(s.dtype)
        all_reduce(s)
        all_reduce(n)
        denom = n.clamp(min=1.0)
        loss = s / denom
        isnan = torch.isnan(loss)
        grads = {}
        for name, p in model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            all_reduce(g)
            g = g / denom
            # NaN-loss zeroing, the single-device rule
            grads[name] = torch.where(isnan, torch.zeros_like(g), g)
        model.zero_grad(set_to_none=True)
        return torch.where(isnan, torch.zeros_like(loss), loss), grads

    @torch.no_grad()
    def eval_step(feats, neighbors):
        _check_shapes(grid, feats, chunk)
        model.eval()
        return gather(runner._call_model(local(feats, 1),
                                         local(neighbors, 2)))

    @torch.no_grad()
    def ssa_step(feats):
        _check_shapes(grid, feats, chunk)
        model.eval()
        return gather(model.get_ssa_feats(local(feats, 1)))

    return MidfcParallelSteps(grad=grad_step, eval=eval_step,
                              ssa_feats=ssa_step)
