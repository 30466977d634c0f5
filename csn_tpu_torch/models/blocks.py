"""Residual blocks over the sparse voxel batches.

Counterpart of `csn_tpu/models/blocks.py`. Attribute names follow the flax
module names (`SparseConv_0` -> `conv_0`, `Norm_0` -> `norm_0`, ...) so the
weight converter maps them one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from csn_tpu_torch.models.layers import (
    MaskedBatchNorm, SparseConv, relu_masked,
)


class BasicBlock(nn.Module):
    """Two 3x3x3 sparse convs + residual (`resnet_block.py:8-57`), with BN.
    The HRNet branches keep their width, so the residual is the input; the
    projection for a width change comes with the model families that need
    it."""

    def __init__(self, planes: int, level: int):
        super().__init__()
        self.level = level
        mname = f"same{level}k3"
        self.conv_0 = SparseConv(planes, planes, mname)
        self.norm_0 = MaskedBatchNorm(planes)
        self.conv_1 = SparseConv(planes, planes, mname)
        self.norm_1 = MaskedBatchNorm(planes)

    def forward(self, batch, x: torch.Tensor) -> torch.Tensor:
        mask = batch.masks[self.level]
        shape = mask.shape
        out = self.conv_0(batch, x, shape)
        out = relu_masked(self.norm_0(out, mask), mask)
        out = self.norm_1(self.conv_1(batch, out, shape), mask)
        return relu_masked(out + x, mask)
