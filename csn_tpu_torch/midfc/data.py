"""MID-FC precomputed-feature datasets.

Port of `MID-FC/features_data_loader.py`: per-shape `.npy` files under
`fc_1/` (features, stored as [1, 256, H, 1]) and `point_labels/` (labels [H]),
padded to 10000 points by repeating the prefix (`features_data_loader.py:37-43`).
`CSAFeaturesDataset` additionally serves, per shape, the [self]+K neighbor
feature stack selected by a kNN graph row (`features_data_loader.py:79-140`).

Served layout is `[P, C]` (channel-last), as in the JAX package, instead of
the reference's `[1, C, H, 1]`. numpy only: the port's own copy of
`csn_tpu/midfc/data.py`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

PAD_POINTS = 10000


def _pad_repeat(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad along axis 0 by repeating the prefix (may tile several times for
    very small shapes; the reference only ever needs one repetition)."""
    n = arr.shape[0]
    if n >= target:
        return arr[:target]
    reps = []
    remaining = target - n
    while remaining > 0:
        take = min(n, remaining)
        reps.append(arr[:take])
        remaining -= take
    return np.concatenate([arr] + reps, axis=0)


def load_feature_file(path: str, num_points: int = PAD_POINTS) -> np.ndarray:
    """Load one fc_1 feature file -> [P, C] float32."""
    with open(path, "rb") as f:
        feats = np.load(f)
    # stored as [1, C, H, 1]
    feats = np.squeeze(np.squeeze(feats, axis=-1), axis=0).T  # [H, C]
    return _pad_repeat(feats.astype(np.float32), num_points)


def load_label_file(path: str, num_points: int = PAD_POINTS) -> np.ndarray:
    with open(path, "rb") as f:
        label = np.load(f).astype(np.int32)
    label = label.reshape(-1)
    return _pad_repeat(label, num_points)


class FeaturesDataset:
    """`features_data_loader.py:9-48`."""

    def __init__(self, dataroot: str, num_points: int = PAD_POINTS):
        self.dataroot = dataroot
        self.features_dir = os.path.join(dataroot, "fc_1")
        self.labels_dir = os.path.join(dataroot, "point_labels")
        self.files = sorted(os.listdir(self.features_dir))
        self.num_points = num_points

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        f = self.files[idx]
        feats = load_feature_file(os.path.join(self.features_dir, f),
                                  self.num_points)
        label = load_label_file(os.path.join(self.labels_dir, f),
                                self.num_points)
        return feats, label

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None):
        """Yield ([B, P, C] feats, [B, P] labels) numpy batches. The final
        short batch is padded by repeating its last shape (with a valid-count
        so metrics can skip duplicates)."""
        order = np.arange(len(self))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for i in range(0, len(order), batch_size):
            idxs = order[i : i + batch_size]
            valid = len(idxs)
            while len(idxs) < batch_size:
                idxs = np.concatenate([idxs, idxs[-1:]])
            fs, ls = zip(*(self[int(j)] for j in idxs))
            yield np.stack(fs), np.stack(ls), valid


class CSAFeaturesDataset:
    """`features_data_loader.py:79-140` (CSADatasetK): per shape, serve
    (feats, label, neighbor_feats [K+1, P, C]) with self at index 0 and K
    graph neighbors (skipping the shape itself) after it."""

    def __init__(self, dataroot: str, dataroot_k: str, knn_graph: np.ndarray,
                 K: int, num_points: int = PAD_POINTS,
                 same_collection: Optional[bool] = None):
        self.base = FeaturesDataset(dataroot, num_points)
        self.neighbors_dir = os.path.join(dataroot_k, "fc_1")
        self.neighbor_files = sorted(os.listdir(self.neighbors_dir))
        self.knn_graph = np.copy(knn_graph)
        self.K = K
        self.num_points = num_points
        if same_collection is None:
            same_collection = os.path.abspath(dataroot) == os.path.abspath(
                dataroot_k)
        self.same_collection = same_collection

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int):
        feats, label = self.base[idx]
        stack = [feats]
        for kidx in self.knn_graph[idx]:
            # skip self when querying within the same collection
            if not (self.same_collection and int(kidx) == idx):
                stack.append(load_feature_file(
                    os.path.join(self.neighbors_dir,
                                 self.neighbor_files[int(kidx)]),
                    self.num_points))
            if len(stack) == self.K + 1:
                break
        while len(stack) < self.K + 1:  # graph row shorter than K (edge case)
            stack.append(stack[-1])
        return feats, label, np.stack(stack)

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None):
        order = np.arange(len(self))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for i in range(0, len(order), batch_size):
            idxs = order[i : i + batch_size]
            valid = len(idxs)
            while len(idxs) < batch_size:
                idxs = np.concatenate([idxs, idxs[-1:]])
            fs, ls, ns = zip(*(self[int(j)] for j in idxs))
            yield np.stack(fs), np.stack(ls), np.stack(ns), valid


def write_synthetic_midfc(root: str, n_shapes: int = 6, num_points: int = 40,
                          channels: int = 16, num_classes: int = 5,
                          seed: int = 0) -> str:
    """Tiny synthetic MID-FC feature dump (test fixture mirroring the on-disk
    contract of `tfsolver.py:206-268`)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "fc_1"), exist_ok=True)
    os.makedirs(os.path.join(root, "point_labels"), exist_ok=True)
    for i in range(n_shapes):
        h = num_points - (i % 3) * 5  # varying point counts to exercise pad
        feats = rng.normal(size=(1, channels, h, 1)).astype(np.float32)
        labels = rng.integers(0, num_classes, size=(h,)).astype(np.int64)
        np.save(os.path.join(root, "fc_1", f"shape_{i}.npy"), feats)
        np.save(os.path.join(root, "point_labels", f"shape_{i}.npy"), labels)
    return root
