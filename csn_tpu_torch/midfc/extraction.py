"""MID-FC feature extraction and the on-disk contract helpers.

Counterpart of `csn_tpu/midfc/extraction.py`. The reference produces the
MID-FC branch's inputs with a TF1 octree HRNet inside O-CNN
(`MID-FC/ocnn_extraction/`: `run_seg_partnet.py`, `network_hrnet.py`, and the
`tfsolver.py:206-268` `test()` loop writing `fc_1/`, `pts/`, `point_labels/`,
`midfc_pred/` npy directories per split and category). Here, as in the JAX
package, the extractor is the package's own sparse-voxel `HRNetSeg`, trained
with the ordinary segmentation objective by `SegTrainer`, whose 2-layer head
exposes the same `fc_1` hidden feature (`HRNetSeg(..., return_fc1=True)`),
read out per point by trilinear interpolation (the `interp_fwd` kernel on
the card). `extract_split` writes the MID-FC on-disk contract, so the
SSA -> kNN -> CSA chain (`csn_tpu_torch/midfc/training.py`) runs end to end
from raw point clouds. CLI: `python -m csn_tpu_torch.tasks.extract_features`.

Directory layout per (split, category):
    <root>/<split>/<Category>/fc_1/shape_i.npy          [1, C, H_i, 1] float32
    <root>/<split>/<Category>/point_labels/shape_i.npy  [H_i] int
    (optional) pts/shape_i.npy, midfc_pred/shape_i.npy

The model carries its own parameters and device, so the functions take no
`variables` argument (the one difference from the JAX package's signatures).
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np
import torch

from csn_tpu_torch.core.interp import interp_batch
from csn_tpu_torch.core.pyramid import to_torch
from csn_tpu_torch.train.losses import predict_nonzero


def export_features(
    out_root: str,
    shapes: Iterable[Tuple[str, np.ndarray, np.ndarray]],
    pts: bool = False,
):
    """Write (name, point_feats [H, C], labels [H]) shapes in the MID-FC
    on-disk format (`tfsolver.py:241-268`)."""
    fc_dir = os.path.join(out_root, "fc_1")
    lab_dir = os.path.join(out_root, "point_labels")
    os.makedirs(fc_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    for name, feats, labels in shapes:
        arr = np.asarray(feats, dtype=np.float32).T[None, :, :, None]
        np.save(os.path.join(fc_dir, f"{name}.npy"), arr)
        np.save(os.path.join(lab_dir, f"{name}.npy"),
                np.asarray(labels).astype(np.int64))


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def extract_split(model, dataset, spec, out_root: str, batch_size: int = 4,
                  save_pts: bool = True) -> int:
    """The `tfsolver.py:206-268` extraction loop: run the trained HRNetSeg
    (on the device its parameters lie on, in eval mode) on every shape of
    `dataset`, without augmentation, and dump per-shape `fc_1/` (stored
    `[1, C, H, 1]` like the reference), `point_labels/`, `pts/` and
    `midfc_pred/` npy files under `out_root`. Returns the number of shapes
    written."""
    from csn_tpu_torch.train.trainer import build_batch_from_dataset

    device = _device_of(model)
    model.eval()
    dirs = {n: os.path.join(out_root, n)
            for n in ("fc_1", "point_labels", "pts", "midfc_pred")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    rng = np.random.default_rng(0)
    n = len(dataset)
    written = 0
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        valid = len(idxs)
        while len(idxs) < batch_size:
            idxs.append(idxs[-1])
        qb_host = build_batch_from_dataset(dataset, idxs, spec, rng,
                                           augment=False)
        qb = to_torch(qb_host, device)
        logits, fc1 = model(qb, return_fc1=True)
        pt_fc1 = interp_batch(fc1, qb).float().cpu().numpy()
        pred = predict_nonzero(interp_batch(logits, qb)).cpu().numpy()
        for b in range(valid):
            m = qb_host.point_mask[b]
            name = f"{start + b:05d}"
            feats = pt_fc1[b][m].astype(np.float32)        # [H, C]
            np.save(os.path.join(dirs["fc_1"], name + ".npy"),
                    feats.T[None, :, :, None])
            np.save(os.path.join(dirs["point_labels"], name + ".npy"),
                    qb_host.labels[b][m].astype(np.int64))
            np.save(os.path.join(dirs["midfc_pred"], name + ".npy"),
                    pred[b][m].astype(np.int64))
            if save_pts:
                np.save(os.path.join(dirs["pts"], name + ".npy"),
                        (qb_host.points[b][m] * spec.voxel_size
                         ).astype(np.float32))
            written += 1
    return written


@torch.no_grad()
def export_from_model(out_root: str, model, batches, names: Iterable[str]):
    """Per-point SSA features of a CSN model (`return_ssa=True`) for each
    voxel batch (host `VoxelBatch` or `TorchVoxelBatch`), read out by
    trilinear interpolation and dumped in the MID-FC format."""
    device = _device_of(model)
    model.eval()
    name_it = iter(names)
    out = []
    for vb in batches:
        tb = vb.to(device) if hasattr(vb, "to") else to_torch(vb, device)
        feats = model(tb, return_ssa=True)
        pt_feats = interp_batch(feats, tb).float().cpu().numpy()
        labels = tb.labels.cpu().numpy()
        mask = tb.point_mask.cpu().numpy()
        for b in range(pt_feats.shape[0]):
            m = mask[b]
            out.append((next(name_it), pt_feats[b][m], labels[b][m]))
    export_features(out_root, out)
