"""ResNet family (strided sparse classification-style backbones).

Counterpart of `csn_tpu/models/resnet.py` (mirror of
`MinkowskiNet/models/resnet.py`), with the JAX package's semantics: the
first block of each layer downsamples once (k3/s2 conv + k1/s2 projection),
the rest run at the target level. Logits live on the stride-32 voxels
(`output_level() == 5`), so the segmentation entry points refuse the
family, as the JAX package's do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from csn_tpu_torch.core.pyramid import MapSpec
from csn_tpu_torch.models.blocks import BasicBlock, Bottleneck
from csn_tpu_torch.models.layers import (
    Conv1x1, Norm, NormType, SparseConv, SparseNet, relu_masked, sum_pool,
)


class _StridedBasicBlock(nn.Module):
    """BasicBlock whose first conv moves `level` -> `level + 1` (stride 2);
    the residual is a k1/s2 conv `conv_2` with its norm `norm_2`."""

    def __init__(self, in_planes: int, planes: int, level: int,
                 norm_type: NormType = NormType.BATCH_NORM,
                 bn_momentum: float = 0.02):
        super().__init__()
        self.level = level
        self.conv_0 = SparseConv(in_planes, planes, f"down{level}k3")
        self.norm_0 = Norm(norm_type, planes, bn_momentum)
        self.conv_1 = SparseConv(planes, planes, f"same{level + 1}k3")
        self.norm_1 = Norm(norm_type, planes, bn_momentum)
        self.conv_2 = SparseConv(in_planes, planes, f"down{level}k1")
        self.norm_2 = Norm(norm_type, planes, bn_momentum)

    def forward(self, batch, x: torch.Tensor) -> torch.Tensor:
        m_dst = batch.masks[self.level + 1]
        out = self.conv_0(batch, x, m_dst.shape)
        out = relu_masked(self.norm_0(out, m_dst), m_dst)
        out = self.norm_1(self.conv_1(batch, out, m_dst.shape), m_dst)
        residual = self.norm_2(self.conv_2(batch, x, m_dst.shape), m_dst)
        return relu_masked(out + residual, m_dst)


class ResNetBase(SparseNet):
    BLOCK = BasicBlock
    LAYERS = ()
    INIT_DIM = 64
    PLANES = (64, 128, 256, 512)
    NORM_TYPE = NormType.BATCH_NORM

    @classmethod
    def num_levels(cls) -> int:
        return 6

    @classmethod
    def output_level(cls) -> int:
        """Logits live on stride-32 voxels (level 5); the point readout
        assumes a level-0 output, so `main_seg` rejects the family."""
        return 5

    @classmethod
    def pyramid_requirements(cls, conv1_kernel_size: int = 5
                             ) -> Tuple[MapSpec, ...]:
        maps = [MapSpec("same", 0, conv1_kernel_size)]
        maps += [MapSpec("down", 0, 2), MapSpec("up", 0, 2)]  # sum pooling
        maps += [MapSpec("same", l, 3) for l in range(1, 6)]
        maps += [MapSpec("down", l, 3) for l in range(1, 5)]
        maps += [MapSpec("up", l, 3) for l in range(1, 5)]
        maps += [MapSpec("down", l, 1) for l in range(1, 5)]
        maps += [MapSpec("up", l, 1) for l in range(1, 5)]
        return tuple(dict.fromkeys(maps))

    def __init__(self, out_channels: int, conv1_kernel_size: int = 5,
                 bn_momentum: float = 0.02, compute_dtype: str = "float32",
                 in_channels: int = 3):
        super().__init__(out_channels, compute_dtype)
        nt, bm = self.NORM_TYPE, bn_momentum
        self.conv0 = SparseConv(in_channels, self.INIT_DIM,
                                f"same0k{conv1_kernel_size}",
                                input_grad=False)
        self.norm0 = Norm(nt, self.INIT_DIM, bm)
        widths = (self.INIT_DIM,) + tuple(self.PLANES)
        layers = []
        for i in range(4):
            stage = [_StridedBasicBlock(widths[i], widths[i + 1], i + 1, nt,
                                        bm)]
            stage += [self.BLOCK(widths[i + 1], i + 2, norm_type=nt,
                                 bn_momentum=bm)
                      for _ in range(1, self.LAYERS[i])]
            layers.append(nn.ModuleList(stage))
        self.layers = nn.ModuleList(layers)
        self.final = Conv1x1(self.PLANES[3], out_channels, f32=True)

    def forward(self, batch, keys: Sequence = (),
                generator: Optional[torch.Generator] = None):
        self._no_keys(keys)
        m = batch.masks
        x = self.conv0(batch, batch.vox_feats.to(self.compute_dtype),
                       m[0].shape)
        x = relu_masked(self.norm0(x, m[0]), m[0])
        x = sum_pool(batch, x, "down0k2", m[1].shape)
        for stage in self.layers:
            for blk in stage:
                x = blk(batch, x)
        return self.final(x).float()


class ResNet14(ResNetBase):
    LAYERS = (1, 1, 1, 1)


class ResNet18(ResNetBase):
    LAYERS = (2, 2, 2, 2)


class ResNet34(ResNetBase):
    LAYERS = (3, 4, 6, 3)


class ResNet50(ResNetBase):
    BLOCK = Bottleneck
    LAYERS = (3, 4, 6, 3)


class ResNet101(ResNetBase):
    BLOCK = Bottleneck
    LAYERS = (3, 4, 23, 3)
