"""The eval step (counterpart of `BaseTrainer._make_eval_step` in
`csn_tpu/train/trainer.py`): the forward that serves predictions."""

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
    out = model(qb, keys)
    point_logits = interp_batch(out, qb)
    loss = cross_entropy_ignore(point_logits, qb.labels, ignore_label,
                                qb.point_mask)
    return loss, point_logits, predict_nonzero(point_logits)
