"""Residual blocks over the sparse voxel batches.

Counterpart of `csn_tpu/models/blocks.py`. Attribute names follow the flax
module names (`SparseConv_0` -> `conv_0`, `Norm_0` -> `norm_0`, ...) so the
weight converter maps them one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from csn_tpu_torch.models.layers import (
    Conv1x1, Norm, NormType, SparseConv, relu_masked,
)


class BasicBlock(nn.Module):
    """Two 3x3x3 sparse convs + residual (`resnet_block.py:8-57`). With
    `in_planes` != `planes` (a U-Net decoder block after a skip
    concatenation) the residual is a bias-free pointwise projection
    `conv1x1_0` with its norm `norm_2`."""

    NORM_TYPE = NormType.BATCH_NORM
    expansion = 1

    def __init__(self, planes: int, level: int,
                 in_planes: Optional[int] = None,
                 norm_type: Optional[NormType] = None,
                 bn_momentum: float = 0.02):
        super().__init__()
        self.level = level
        nt = self.NORM_TYPE if norm_type is None else norm_type
        in_planes = planes if in_planes is None else in_planes
        mname = f"same{level}k3"
        self.conv_0 = SparseConv(in_planes, planes, mname)
        self.norm_0 = Norm(nt, planes, bn_momentum)
        self.conv_1 = SparseConv(planes, planes, mname)
        self.norm_1 = Norm(nt, planes, bn_momentum)
        if in_planes != planes * self.expansion:
            self.conv1x1_0 = Conv1x1(in_planes, planes * self.expansion,
                                     use_bias=False)
            self.norm_2 = Norm(nt, planes * self.expansion, bn_momentum)
        else:
            self.conv1x1_0 = None

    def forward(self, batch, x: torch.Tensor) -> torch.Tensor:
        mask = batch.masks[self.level]
        shape = mask.shape
        out = self.conv_0(batch, x, shape)
        out = relu_masked(self.norm_0(out, mask), mask)
        out = self.norm_1(self.conv_1(batch, out, shape), mask)
        residual = x
        if self.conv1x1_0 is not None:
            residual = self.norm_2(self.conv1x1_0(x), mask)
        return relu_masked(out + residual, mask)


class Bottleneck(nn.Module):
    """1-3-1 bottleneck (`resnet_block.py:76-136`; expansion 1, bottleneck 4
    as in the reference): pointwise `conv1x1_0` down to planes / 4, the 3x3x3
    sparse conv `conv_0`, pointwise `conv1x1_1` back up; with a width change
    the projection `conv1x1_2` and its norm `norm_3`."""

    NORM_TYPE = NormType.BATCH_NORM
    expansion = 1
    bottleneck = 4

    def __init__(self, planes: int, level: int,
                 in_planes: Optional[int] = None,
                 norm_type: Optional[NormType] = None,
                 bn_momentum: float = 0.02):
        super().__init__()
        self.level = level
        nt = self.NORM_TYPE if norm_type is None else norm_type
        in_planes = planes if in_planes is None else in_planes
        mid = planes // self.bottleneck
        out_planes = planes * self.expansion
        self.conv1x1_0 = Conv1x1(in_planes, mid, use_bias=False)
        self.norm_0 = Norm(nt, mid, bn_momentum)
        self.conv_0 = SparseConv(mid, mid, f"same{level}k3")
        self.norm_1 = Norm(nt, mid, bn_momentum)
        self.conv1x1_1 = Conv1x1(mid, out_planes, use_bias=False)
        self.norm_2 = Norm(nt, out_planes, bn_momentum)
        if in_planes != out_planes:
            self.conv1x1_2 = Conv1x1(in_planes, out_planes, use_bias=False)
            self.norm_3 = Norm(nt, out_planes, bn_momentum)
        else:
            self.conv1x1_2 = None

    def forward(self, batch, x: torch.Tensor) -> torch.Tensor:
        mask = batch.masks[self.level]
        out = relu_masked(self.norm_0(self.conv1x1_0(x), mask), mask)
        out = self.conv_0(batch, out, mask.shape)
        out = relu_masked(self.norm_1(out, mask), mask)
        out = self.norm_2(self.conv1x1_1(out), mask)
        residual = x
        if self.conv1x1_2 is not None:
            residual = self.norm_3(self.conv1x1_2(x), mask)
        return relu_masked(out + residual, mask)


class BasicBlockIN(BasicBlock):
    """`resnet_block.py:62-63`."""

    NORM_TYPE = NormType.INSTANCE_NORM


class BasicBlockINBN(BasicBlock):
    """`resnet_block.py:66-67`."""

    NORM_TYPE = NormType.INSTANCE_BATCH_NORM


class BasicBlockLN(BasicBlock):
    """`resnet_block.py:70-71`."""

    NORM_TYPE = NormType.LAYER_NORM


class BottleneckIN(Bottleneck):
    """`resnet_block.py:143-144`."""

    NORM_TYPE = NormType.INSTANCE_NORM


class BottleneckINBN(Bottleneck):
    """`resnet_block.py:147-148`."""

    NORM_TYPE = NormType.INSTANCE_BATCH_NORM


BLOCKS = {
    "BasicBlock": BasicBlock, "Bottleneck": Bottleneck,
    "BasicBlockIN": BasicBlockIN, "BasicBlockINBN": BasicBlockINBN,
    "BasicBlockLN": BasicBlockLN, "BottleneckIN": BottleneckIN,
    "BottleneckINBN": BottleneckINBN,
}
