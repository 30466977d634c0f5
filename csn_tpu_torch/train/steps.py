"""The train and eval steps (counterparts of `BaseTrainer._make_grad_step`
followed by `_make_apply_step`, of `_make_eval_step`, and of
`CSNTrainer._make_cached_eval_step`, in `csn_tpu/train/trainer.py`)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from csn_tpu_torch.core.interp import interp_batch
from csn_tpu_torch.train.losses import cross_entropy_ignore, predict_nonzero


@torch.no_grad()
def eval_step(model, qb, keys: Sequence = (), ignore_label: int = 255
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One query batch `qb` (+ its K key batches) through the model in eval
    mode -> (loss, point_logits [B, P, C] f32, pred [B, P])."""
    model.eval()
    out = model(qb, keys)
    point_logits = interp_batch(out, qb)
    loss = cross_entropy_ignore(point_logits, qb.labels, ignore_label,
                                qb.point_mask)
    return loss, point_logits, predict_nonzero(point_logits)


@torch.no_grad()
def cached_eval_step(model, qb, key_feats, key_pools, key_masks,
                     ignore_label: int = 255
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`eval_step` on precomputed neighbor features (`csa_from_cache`):
    key_feats [B, K, L0, d], key_pools [B, K, d], key_masks [B, K, L0]."""
    model.eval()
    out = model.csa_from_cache(qb, key_feats, key_pools, key_masks)
    point_logits = interp_batch(out, qb)
    loss = cross_entropy_ignore(point_logits, qb.labels, ignore_label,
                                qb.point_mask)
    return loss, point_logits, predict_nonzero(point_logits)


def grad_step(model, qb, keys: Sequence, generator: torch.Generator,
              ignore_label: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward in train mode (BatchNorm on batch statistics, updated in
    place; attention dropout drawn from the CPU `generator`), the point
    readout, the cross entropy ignoring `ignore_label`, and the backward,
    which ADDS to the parameters' `.grad`. Returns (loss, pred [B, P]),
    both detached."""
    model.train()
    out = model(qb, keys, generator=generator)
    point_logits = interp_batch(out, qb)
    loss = cross_entropy_ignore(point_logits, qb.labels, ignore_label,
                                qb.point_mask)
    loss.backward()
    return loss.detach(), predict_nonzero(point_logits.detach())


def train_step(model, optimizer: torch.optim.Optimizer, qb, keys: Sequence,
               generator: torch.Generator, ignore_label: int = 255
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimisation step on query batch `qb` (+ its K key batches):
    `grad_step` from zeroed gradients and one `optimizer` step. Returns
    (loss, pred [B, P])."""
    optimizer.zero_grad(set_to_none=True)
    res = grad_step(model, qb, keys, generator, ignore_label)
    optimizer.step()
    return res
