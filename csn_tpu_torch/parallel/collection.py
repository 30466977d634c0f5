"""The collection cache sharded over the ranks, and the neighbour exchange of
the cached CSA evaluation.

Counterpart of `csn_tpu/parallel/collection.py`. The per-shape cached key
features (`HRNetSimCSN.cache_features`: cross-attention K/V and pooled SSA)
are sharded over the ranks of a data-parallel world, each rank holding
ceil(N / n) collection shapes, instead of every rank holding all N. A
query's K neighbour rows live on any rank, so the fetch is a masked local
gather and one reduce-scatter: every rank gathers the whole replicated
request set from its own shard (zeros for rows it does not own; each row
has exactly one owner), and the reduce-scatter hands each rank exactly its
own [B, K, L0, d] block, so every row crosses the interconnect once.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from csn_tpu_torch.core.interp import interp_batch
from csn_tpu_torch.parallel.dp import DPWorld
from csn_tpu_torch.train.losses import cross_entropy_ignore, predict_nonzero


def shard_collection(feats, pools, masks, world: DPWorld
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                int]:
    """This rank's shard of a host collection cache, on `world.device`:
    rows [rank * per, (rank + 1) * per) of feats [N, L0, d] (f16), pools
    [N, d] f32 and masks [N, L0] bool, N zero-padded to per * n rows (the
    padding is never requested: neighbour ids are < N). Returns (feats,
    pools, masks, per)."""
    n = feats.shape[0]
    per = -(-n // world.size)
    lo = world.rank * per
    return (*(shard_rows(x[lo:lo + per], per, world.device)
              for x in (feats, pools, masks)), per)


def shard_rows(x, per: int, device) -> torch.Tensor:
    """Host rows `x` (at most `per`) zero-padded to `per`, on `device`."""
    x = np.asarray(x)
    x = np.pad(x, ((0, per - x.shape[0]),) + ((0, 0),) * (x.ndim - 1))
    return torch.from_numpy(x).to(device)


def exchange_rows(cf, cp, cm, idx_all, per: int, world: DPWorld):
    """This rank's rows of the collection: cf [per, L0, d] / cp [per, d] /
    cm [per, L0] is the local shard; idx_all [n, ...] holds the GLOBAL row
    ids that every rank wants, the same on every rank. Each rank gathers
    the rows it owns for the whole request set (zeros elsewhere) and one
    reduce-scatter per tensor hands rank r exactly the rows of idx_all[r].
    Returns (feats, pools, masks) with leading dims idx_all.shape[1:]."""
    req = tuple(idx_all.shape[1:])
    flat = idx_all.reshape(-1).to(cf.device).long()
    local = flat - world.rank * per
    valid = (local >= 0) & (local < per)
    li = local.clamp(0, per - 1)

    def scatter(x):
        rows = torch.where(valid.view(-1, *([1] * (x.dim() - 1))), x[li],
                           torch.zeros((), dtype=x.dtype, device=x.device))
        out = rows.new_empty((rows.shape[0] // world.size,) + rows.shape[1:])
        dist.reduce_scatter_tensor(out, rows.contiguous(), group=world.group)
        return out.reshape(req + out.shape[1:])

    return scatter(cf), scatter(cp), scatter(cm.int()) > 0


def make_dp_cache_step(model, world: DPWorld) -> Callable:
    """(qb) -> (feats [n, B, L0, d] f16, pools [n, B, d] f32): every
    rank's collection batch through `cache_features`, gathered (the cache
    keeps the features in f16)."""

    @torch.no_grad()
    def step(qb):
        model.eval()
        feats, pools = model.cache_features(qb)
        return world.gather(feats.to(torch.float16)), \
            world.gather(pools.float())

    return step


def make_dp_cached_eval_step(model, world: DPWorld, *, per: int,
                             ignore_label: int = 255) -> Callable:
    """(qb, cf, cp, cm, idx_all) -> (loss [n], point_logits [B, P, C] of
    this rank, pred [n, B, P]): this rank's query batch through
    `csa_from_cache` on its neighbour rows, fetched by `exchange_rows`.
    idx_all [n, B, K]: the GLOBAL neighbour ids of every rank's queries."""

    @torch.no_grad()
    def step(qb, cf, cp, cm, idx_all):
        model.eval()
        kf, kp, km = exchange_rows(cf, cp, cm, idx_all, per, world)
        out = model.csa_from_cache(qb, kf, kp, km)
        point_logits = interp_batch(out, qb)
        loss = cross_entropy_ignore(point_logits, qb.labels, ignore_label,
                                    qb.point_mask)
        return (world.gather(loss), point_logits,
                world.gather(predict_nonzero(point_logits)))

    return step
