"""The train and eval steps (counterparts of `BaseTrainer._make_grad_step`
followed by `_make_apply_step`, and of `_make_eval_step`, in
`csn_tpu/train/trainer.py`)."""

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


def train_step(model, optimizer: torch.optim.Optimizer, qb, keys: Sequence,
               generator: torch.Generator, ignore_label: int = 255
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimisation step on query batch `qb` (+ its K key batches): the
    forward in train mode (BatchNorm on batch statistics, attention dropout
    drawn from the CPU `generator`), the point readout, the cross entropy
    ignoring `ignore_label`, the backward and one `optimizer` step. Returns
    (loss, pred [B, P]), both detached; the BatchNorm running statistics are
    updated in place."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(qb, keys, generator=generator)
    point_logits = interp_batch(out, qb)
    loss = cross_entropy_ignore(point_logits, qb.labels, ignore_label,
                                qb.point_mask)
    loss.backward()
    optimizer.step()
    return loss.detach(), predict_nonzero(point_logits.detach())
