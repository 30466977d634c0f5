"""Seeded synthetic shapes for smoke runs and tests (numpy only): the
port's own copy of the shape generator of the JAX package's `bench.py`, so
that both draw the same shapes from the same seed, and the synthetic
PartNet category of `write_synthetic_partnet` built in memory, for a
machine without h5py."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from csn_tpu_torch.data.partnet import NUM_SEG, PartnetDataset

SPLITS = ("train", "val", "test")


def make_surface_shape(rng, n_points=10000):
    """Points on a few spherical/planar patches -> surface-like occupancy."""
    pts = []
    n_left = n_points
    for _ in range(rng.integers(2, 5)):
        n = min(int(rng.integers(n_points // 4, n_points // 2)), n_left)
        if n <= 0:
            break
        kind = rng.integers(0, 2)
        if kind == 0:  # sphere shell patch
            v = rng.normal(size=(n, 3))
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            r = rng.uniform(0.4, 1.0)
            c = rng.uniform(-0.2, 0.2, size=3)
            pts.append(v * r + c)
        else:  # planar patch
            a = rng.uniform(-1, 1, size=(n, 2))
            z = np.full((n, 1), rng.uniform(-0.8, 0.8))
            p = np.concatenate([a, z], axis=1)
            perm = rng.permutation(3)
            pts.append(p[:, perm])
        n_left -= n
    if n_left > 0:
        v = rng.normal(size=(n_left, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts.append(v)
    coords = np.concatenate(pts)[:n_points].astype(np.float32)
    labels = ((coords[:, 0] > 0).astype(np.int32)
              + 2 * (coords[:, 1] > 0).astype(np.int32)) + 1
    return coords, coords.copy(), labels


class SurfaceShapeDataset:
    """An in-memory collection of `make_surface_shape` shapes with the
    interface the trainers use of `PartnetDataset` (`get`, `__len__`,
    `coords`, `labels`, `neighbors`, `num_points`): a PartNet-like split
    that needs no h5 file. No augmentation."""

    def __init__(self, n_shapes: int, num_points: int, seed: int):
        rng = np.random.default_rng(seed)
        shapes = [make_surface_shape(rng, num_points)
                  for _ in range(n_shapes)]
        self.coords = [c for c, _, _ in shapes]
        self.labels = [l for _, _, l in shapes]
        self.neighbors = [(i, []) for i in range(n_shapes)]

    def __len__(self) -> int:
        return len(self.coords)

    @property
    def num_points(self) -> int:
        return max(c.shape[0] for c in self.coords)

    def get(self, index: int, rng=None, augment: bool = True):
        """(coords [P, 3], feats [P, 3], labels [P]): the features are the
        coordinates, as in `PartnetDataset.get`."""
        coords = np.copy(self.coords[index])
        return coords, coords.copy(), np.copy(self.labels[index])


def synthetic_partnet_arrays(category: str = "Chair", n_train: int = 8,
                             n_val: int = 4, n_test: int = 4,
                             num_points: int = 256,
                             num_labels: Optional[int] = None, seed: int = 0
                             ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{split: (data [n, P, 3] f32, label_seg [n, P])}: the arrays that
    `write_synthetic_partnet` (`data/partnet.py`, and the JAX package's) writes
    for the same arguments, drawn in its order from one `default_rng(seed)`
    (train, then val, then test): uniform points in [-1, 1]^3, labels from
    the signs of x and y taken % (num_labels - 1) + 1, 5 % of them set to 0."""
    rng = np.random.default_rng(seed)
    num_labels = num_labels or NUM_SEG.get(category, 8)
    out = {}
    for phase, n in zip(SPLITS, (n_train, n_val, n_test)):
        pts = rng.uniform(-1, 1, size=(n, num_points, 3)).astype(np.float32)
        labs = (
            (pts[..., 0] > 0).astype(np.int32)
            + 2 * (pts[..., 1] > 0).astype(np.int32)
        ) % max(num_labels - 1, 1) + 1
        zero_mask = rng.random((n, num_points)) < 0.05
        out[phase] = (pts, np.where(zero_mask, 0, labs))
    return out


def synthetic_partnet_splits(category: str = "Chair", n_train: int = 8,
                             n_val: int = 4, n_test: int = 4,
                             num_points: int = 256,
                             num_labels: Optional[int] = None, seed: int = 0
                             ) -> Dict[str, PartnetDataset]:
    """{split: PartnetDataset}: what `PartnetDataset` reads back (normalized
    to the unit sphere, no augmentation) from the files
    `write_synthetic_partnet` writes for the same arguments, built in
    memory."""
    return {phase: PartnetDataset.from_arrays(data, labs, category, phase)
            for phase, (data, labs) in synthetic_partnet_arrays(
                category, n_train, n_val, n_test, num_points, num_labels,
                seed).items()}
