"""Segmentation metrics: the port's own copy of `csn_tpu/train/metrics.py`,
the host-side definitions in numpy and the batched I/U counts in torch on
any device.

The two branches define IoU slightly differently; each is reproduced
faithfully:

* Mink branch (`MinkowskiNet/lib/utils.py:64-176`):
  - `precision_at_one_partnet`: label 0 counts as correct, 255 ignored.
  - `calculate_iou`: per-shape I/U for labels 1..L-1, predictions forced to 0
    where ground truth is 0, labels absent from both sets skipped.
  - `calculate_shape_iou`: mean over shapes of mean present-label IoU.
  - `calculate_part_iou`: dataset-aggregated I/U per label, averaged over
    (num_labels - 1) labels (absent labels contribute 0).

* MID-FC branch (`MID-FC/ssa_training.py:99-123`): per-shape I/U accumulated
  over labels 1..L-1 without the union-present filter; normalizes by
  (class_num - 1) including absent labels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Mink branch metrics (numpy, exact)
# ---------------------------------------------------------------------------

def precision_at_one_partnet(pred: np.ndarray, target: np.ndarray,
                             ignore_label: int = 255) -> float:
    """`lib/utils.py:64-75`."""
    pred = np.asarray(pred).reshape(-1)
    target = np.asarray(target).reshape(-1)
    correct = (pred == target) | (target == 0)
    correct = correct[target != ignore_label]
    if correct.size == 0:
        return float("nan")
    return float(correct.sum() * 100.0 / correct.size)


def calculate_iou(ground: np.ndarray, prediction: np.ndarray,
                  num_labels: int) -> Dict:
    """`lib/utils.py:78-110`."""
    ground = np.asarray(ground).reshape(-1)
    prediction = np.copy(np.asarray(prediction).reshape(-1))
    prediction[ground == 0] = 0
    label_iou, intersection, union = {}, {}, {}
    for i in range(1, num_labels):
        inter_i = int(np.sum((ground == i) & (prediction == i)))
        union_i = int(np.sum((ground == i) | (prediction == i)))
        if union_i > 0:
            intersection[i] = float(inter_i)
            union[i] = float(union_i)
            label_iou[i] = intersection[i] / union[i]
    return {"label_iou": label_iou, "intersection": intersection,
            "union": union}


def calculate_shape_iou(ious: Dict) -> float:
    """`lib/utils.py:113-139`."""
    shape_iou, cnt = {}, 0
    for name, metrics in ious.items():
        L_s = len(metrics["label_iou"])
        if L_s > 0:
            shape_iou[name] = np.nan_to_num(
                np.sum(list(metrics["label_iou"].values())) / float(L_s))
            cnt += 1
    if cnt == 0:
        return 0.0
    return float(np.sum(list(shape_iou.values())) / float(cnt))


def calculate_part_iou(ious: Dict, num_labels: int) -> float:
    """`lib/utils.py:142-176`."""
    intersection = {i: 0.0 for i in range(1, num_labels)}
    union = {i: 0.0 for i in range(1, num_labels)}
    for name, metrics in ious.items():
        for label in metrics["intersection"]:
            intersection[label] += metrics["intersection"][label]
            union[label] += metrics["union"][label]
    part_iou = {}
    for key in range(1, num_labels):
        part_iou[key] = (intersection[key] / union[key]) if union[key] > 0 else 0.0
    return float(np.sum(list(part_iou.values())) / float(num_labels - 1))


# ---------------------------------------------------------------------------
# Device-side batched I/U accumulation (for fast eval loops)
# ---------------------------------------------------------------------------

def batch_intersection_union(pred: torch.Tensor, target: torch.Tensor,
                             mask: torch.Tensor, num_labels: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shape intersection and union counts of labels 0..num_labels-1,
    on the tensors' own device (plain torch: the JAX function is `jnp`, no
    kernel), with the prediction forced to 0 where the target is 0 (Mink
    convention) and only positions where `mask` [B, P] (valid and not
    ignored) is true counted. pred, target [B, P] integer. Returns (inter
    [B, num_labels], union [B, num_labels]) int64; `mink_metrics_from_iu`
    reads labels 1..num_labels-1."""
    pred = torch.where(target == 0, torch.zeros_like(pred), pred)
    labels = torch.arange(num_labels, device=pred.device)
    valid = mask.to(torch.bool)[..., None]
    g = (target[..., None] == labels) & valid
    p = (pred[..., None] == labels) & valid
    return (g & p).sum(dim=1), (g | p).sum(dim=1)


def mink_metrics_from_iu(inter: np.ndarray, union: np.ndarray,
                         num_labels: int) -> Tuple[float, float]:
    """(part IoU, shape IoU) of per-shape I/U counts [N_shapes, num_labels]
    (`batch_intersection_union`'s, on the host) with the exact Mink-branch
    semantics of `calculate_iou` / `calculate_part_iou` /
    `calculate_shape_iou`: labels 1..num_labels-1 with a nonzero union."""
    inter, union = np.asarray(inter), np.asarray(union)
    ious = {}
    for s in range(inter.shape[0]):
        label_iou, inter_d, union_d = {}, {}, {}
        for i in range(1, num_labels):
            if union[s, i] > 0:
                inter_d[i] = float(inter[s, i])
                union_d[i] = float(union[s, i])
                label_iou[i] = inter_d[i] / union_d[i]
        ious[s] = {"label_iou": label_iou, "intersection": inter_d,
                   "union": union_d}
    return calculate_part_iou(ious, num_labels), calculate_shape_iou(ious)


# ---------------------------------------------------------------------------
# MID-FC branch metric (`MID-FC/ssa_training.py:99-123,158-192`)
# ---------------------------------------------------------------------------

class MidfcIoUAccumulator:
    """Dataset-aggregated part IoU, MID-FC style: on points with label > 0,
    accumulate I/U per label k in 0..class_num-1 (prediction is a plain argmax
    over all classes, so label 0 can appear in the union), then
    sum_k I_k/(U_k + 1e-10) / (class_num - 1)."""

    def __init__(self, class_num: int):
        self.class_num = class_num
        self.intsc = np.zeros(class_num, dtype=np.float64)
        self.union = np.zeros(class_num, dtype=np.float64)

    def update(self, pred: np.ndarray, target: np.ndarray):
        pred = np.asarray(pred).reshape(-1)
        target = np.asarray(target).reshape(-1)
        m = target > 0
        pred, target = pred[m], target[m]
        for k in range(self.class_num):
            pk, lk = pred == k, target == k
            self.intsc[k] += float(np.sum(pk & lk))
            self.union[k] += float(np.sum(pk | lk))

    def result(self) -> float:
        iou = (self.intsc / (self.union + 1e-10)).sum()
        return float(iou / (self.class_num - 1))
