"""Point-cloud augmentations and normalization.

Exact functional ports of `MinkowskiNet/lib/transforms.py:12-101,195-225`
(RandomShift / RandomJittering / RandomScaling / RotationAugmentation /
Compose, sphere/box coordinate normalization) driven by an explicit
`np.random.Generator` instead of global numpy state.

PartNet parameter bounds live on the dataset class
(`lib/datasets/partnet.py:36-40`): rotation +-5deg about y, jitter 0.25,
scale (0.75, 1.25), shift (sigma=0.01, clip=0.05).

The port's own copy of `csn_tpu/data/transforms.py` (no JAX in either).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_THRESHOLD_TOL_32 = 2.0 * np.finfo(np.float32).eps
_THRESHOLD_TOL_64 = 2.0 * np.finfo(np.float64).eps

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray]


class RandomShift:
    """`transforms.py:12-29`: gaussian shift scaled by bbox diagonal."""

    def __init__(self, sigma: float = 0.01, clip: float = 0.05):
        assert clip > 0
        self.sigma = sigma
        self.clip = clip

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        bb = coords.max(axis=0) - coords.min(axis=0)
        bb_len = np.sqrt(np.sum(bb ** 2))
        std = self.sigma * bb_len
        shift = np.clip(std * rng.standard_normal((1, 3)), -self.clip, self.clip)
        return coords + shift, feats, labels


class RandomJittering:
    """`transforms.py:32-45`: one uniform offset per axis (whole-shape)."""

    def __init__(self, x_jitter=0.01, y_jitter=0.01, z_jitter=0.01):
        self.jitter = (x_jitter, y_jitter, z_jitter)

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        off = np.array([[rng.uniform(-j, j) for j in self.jitter]])
        return coords + off, feats, labels


class RandomScaling:
    """`transforms.py:48-62`: uniform isotropic scale."""

    def __init__(self, scale_lo=0.9, scale_up=1.1):
        self.scale_lo = scale_lo
        self.scale_up = scale_up

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        s = rng.uniform(self.scale_lo, self.scale_up)
        return coords * s, feats, labels


class RotationAugmentation:
    """`transforms.py:65-89`: rotation about the y (up) axis. The angle is
    sampled per shape by the caller (dataset) within the category bounds."""

    def __init__(self, bound: Tuple[float, float], use_normals: bool = False):
        self.bound = bound
        self.use_normals = use_normals

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        angle = rng.uniform(self.bound[0], self.bound[1])
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        coords = coords @ rot.T
        if self.use_normals:
            feats = np.copy(feats)
            feats[:, 0:3] = feats[:, 0:3] @ rot.T
        return coords, feats, labels


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        for t in self.transforms:
            coords, feats, labels = t(coords, feats, labels, rng)
        return coords, feats, labels


def bounding_box_diagonal(coords: np.ndarray) -> float:
    bb = coords.max(axis=0) - coords.min(axis=0)
    return float(np.sqrt(np.sum(bb ** 2)))


def bounding_sphere_radius(coords: np.ndarray) -> float:
    return float(np.max(np.sqrt(np.sum(coords ** 2, axis=1))))


def normalize_coords(coords: np.ndarray, method: str = "sphere") -> np.ndarray:
    """`transforms.py:195-209`."""
    centroid = coords.mean(axis=0)
    centered = coords - centroid
    if method.lower() == "sphere":
        radius = bounding_sphere_radius(centered)
    elif method.lower() == "box":
        radius = bounding_box_diagonal(centered)
    else:
        raise ValueError(f"Unknown normalization method {method}")
    tol = _THRESHOLD_TOL_64 if coords.dtype == np.float64 else _THRESHOLD_TOL_32
    return centered / max(radius, tol)


def build_prevoxel_transforms(
    dataset_cls,
    rot_aug: bool = False,
    shift: bool = False,
    jitter: bool = False,
    scale: bool = False,
    use_normals: bool = False,
) -> Compose:
    """`lib/dataset.py:275-288`: rotation, then shift XOR jitter, then scale."""
    ts: List = []
    if rot_aug:
        ts.append(RotationAugmentation(dataset_cls.ROTATION_AUGMENTATION_BOUND,
                                       use_normals))
    if shift:
        ts.append(RandomShift(*dataset_cls.SHIFT_PARAMS))
    elif jitter:
        ts.append(RandomJittering(*dataset_cls.JITTER_AUGMENTATION_BOUND))
    if scale:
        ts.append(RandomScaling(*dataset_cls.SCALE_AUGMENTATION_BOUND))
    return Compose(ts)
