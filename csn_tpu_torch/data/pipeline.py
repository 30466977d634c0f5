"""Batch assembly: raw point clouds -> static-shape VoxelBatch for a model.

The port's own copy of `csn_tpu/data/pipeline.py`, less the window-worklist
and dense-stem options that serve the TPU kernels only. Replaces the
reference's collate + ME.TensorField construction
(`lib/transforms.py:104-152`, `lib/trainer_csn.py:236-258`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from csn_tpu_torch.core.pyramid import (
    PyramidSpec, QMode, VoxelBatch, build_voxel_batch, default_level_caps,
)


def pyramid_spec_for_model(
    model_cls,
    num_points: int,
    voxel_size: float,
    conv1_kernel_size: int = 5,
    level_caps: Optional[Tuple[int, ...]] = None,
    level0_cap: Optional[int] = None,
    qmode: QMode = QMode.RANDOM_SUBSAMPLE,
    shrink: float = 3.0,
    sort_points: bool = False,
) -> PyramidSpec:
    """Derive the static pyramid signature a model needs: its levels, the
    kernel maps of its convolutions and the per-level voxel capacities."""
    nl = model_cls.num_levels()
    maps = model_cls.pyramid_requirements(conv1_kernel_size)
    if level_caps is None:
        base = level0_cap if level0_cap is not None else num_points
        level_caps = default_level_caps(base, nl, shrink=shrink)
    return PyramidSpec(
        voxel_size=voxel_size,
        num_points=num_points,
        level_caps=tuple(level_caps),
        maps=tuple(maps),
        qmode=qmode,
        sort_points=sort_points,
    )


def collate_shapes(
    shapes: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    spec: PyramidSpec,
    rng: Optional[np.random.Generator] = None,
    ignore_label: int = 255,
) -> VoxelBatch:
    return build_voxel_batch(shapes, spec, rng=rng, ignore_label=ignore_label)
