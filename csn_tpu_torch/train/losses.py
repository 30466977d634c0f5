"""Losses and prediction rules (counterpart of `csn_tpu/train/losses.py`).

Mink branch: cross entropy ignoring label 255 at the interpolated point
outputs; prediction = argmax over logits[..., 1:] + 1, so label 0 is never
predicted. MID-FC branch: cross entropy masked to labels > 0
(`MID-FC/ssa_training.py:82-96`).
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_label: int = 255,
                         extra_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean cross entropy in f32 over elements whose label is not
    `ignore_label` (and where `extra_mask`, e.g. point padding, is true)."""
    valid = labels != ignore_label
    if extra_mask is not None:
        valid = valid & extra_mask
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def cross_entropy_positive_sum(logits: torch.Tensor, labels: torch.Tensor,
                               extra_mask: Optional[torch.Tensor] = None):
    """(sum of the per-element NLL over labels > 0 in f32, their count).

    The separable form of `cross_entropy_positive_labels`: a sharded step
    all-reduces both parts and divides once, which reproduces the
    single-device mean however the valid labels distribute over the shards
    (a mean of per-shard means would not)."""
    valid = labels > 0
    if extra_mask is not None:
        valid = valid & extra_mask
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum(), valid.sum()


def cross_entropy_positive_labels(logits: torch.Tensor, labels: torch.Tensor,
                                  extra_mask: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """MID-FC masked cross entropy: only labels > 0 contribute
    (`ssa_training.py:87-92`)."""
    s, n = cross_entropy_positive_sum(logits, labels, extra_mask)
    return s / n.clamp(min=1)


def predict_nonzero(logits: torch.Tensor) -> torch.Tensor:
    """argmax over classes 1..C-1, shifted by +1 (label 0 never predicted)."""
    return torch.argmax(logits[..., 1:], dim=-1) + 1
