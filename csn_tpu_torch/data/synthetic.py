"""Seeded synthetic shapes for smoke runs and tests (numpy only): the
port's own copy of the shape generator of the JAX package's `bench.py`, so
that both draw the same shapes from the same seed."""

from __future__ import annotations

import numpy as np


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
