"""Res16UNet family (16x-downsampling sparse U-Nets).

Counterpart of `csn_tpu/models/res16unet.py` (mirror of
`MinkowskiNet/models/res16unet.py`): stem conv (k = conv1_kernel_size), four
k2/s2 downsampling convs with residual stages, four k2/s2 transpose convs
with skip concatenations, final 1x1 head. Width/depth variants
Res16UNet{14,18,34,50,101}{,A,B,C,D,...} as in `res16unet.py:232-306` of the
reference. Module attributes follow the flax names (`down_convs[l]` for
`down_convs_l`, `enc_blocks[l][b]` for `enc_blocks_l_b`, ...) so
`models/convert.py` maps a flax checkpoint one to one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from csn_tpu_torch.core.pyramid import MapSpec
from csn_tpu_torch.models.blocks import BasicBlock, Bottleneck
from csn_tpu_torch.models.layers import (
    Conv1x1, Norm, NormType, SparseConv, SparseNet, relu_masked,
)


def block_stage(block, in_planes: int, planes: int, level: int, n: int,
                norm_type: NormType, bn_momentum: float) -> nn.ModuleList:
    """`n` blocks at `level`; the first takes `in_planes` channels."""
    return nn.ModuleList(
        block(planes, level, in_planes=in_planes if b == 0 else planes,
              norm_type=norm_type, bn_momentum=bn_momentum)
        for b in range(n))


class Res16UNetBase(SparseNet):
    BLOCK = BasicBlock
    PLANES = (32, 64, 128, 256, 256, 256, 256, 256)
    LAYERS = (2, 2, 2, 2, 2, 2, 2, 2)
    INIT_DIM = 32
    NORM_TYPE = NormType.BATCH_NORM

    @classmethod
    def num_levels(cls) -> int:
        return 5

    @classmethod
    def pyramid_requirements(cls, conv1_kernel_size: int = 5
                             ) -> Tuple[MapSpec, ...]:
        maps = [MapSpec("same", 0, conv1_kernel_size)]
        maps += [MapSpec("same", l, 3) for l in range(5)]
        maps += [MapSpec("down", l, 2) for l in range(4)]
        maps += [MapSpec("up", l, 2) for l in range(4)]
        return tuple(dict.fromkeys(maps))  # a k3 stem repeats same0k3

    def __init__(self, out_channels: int, conv1_kernel_size: int = 5,
                 bn_momentum: float = 0.02, compute_dtype: str = "float32",
                 in_channels: int = 3):
        super().__init__(out_channels, compute_dtype)
        nt, bm = self.NORM_TYPE, bn_momentum
        P, L, D = self.PLANES, self.LAYERS, self.INIT_DIM
        self.conv0 = SparseConv(in_channels, D, f"same0k{conv1_kernel_size}")
        self.norm0 = Norm(nt, D, bm)
        # width of level l's encoder output: it enters down conv l and is
        # the skip concatenated at level l
        enc_in = (D,) + tuple(P[:3])
        self.down_convs = nn.ModuleList(
            SparseConv(enc_in[l], enc_in[l], f"down{l}k2") for l in range(4))
        self.down_norms = nn.ModuleList(
            Norm(nt, enc_in[l], bm) for l in range(4))
        self.enc_blocks = nn.ModuleList(
            block_stage(self.BLOCK, enc_in[l], P[l], l + 1, L[l], nt, bm)
            for l in range(4))
        up_in = (P[3],) + tuple(P[4:7])      # width entering up conv s
        self.up_convs = nn.ModuleList(
            SparseConv(up_in[s], P[4 + s], f"up{3 - s}k2") for s in range(4))
        self.up_norms = nn.ModuleList(
            Norm(nt, P[4 + s], bm) for s in range(4))
        self.dec_blocks = nn.ModuleList(
            block_stage(self.BLOCK, P[4 + s] + enc_in[3 - s], P[4 + s], 3 - s,
                        L[4 + s], nt, bm)
            for s in range(4))
        self.final = Conv1x1(P[7], out_channels, f32=True)

    def forward(self, batch, keys: Sequence = (),
                generator: Optional[torch.Generator] = None):
        self._no_keys(keys)
        m = batch.masks
        x = self.conv0(batch, batch.vox_feats.to(self.compute_dtype),
                       m[0].shape)
        x = relu_masked(self.norm0(x, m[0]), m[0])

        skips = [x]
        for l in range(4):
            x = self.down_convs[l](batch, x, m[l + 1].shape)
            x = relu_masked(self.down_norms[l](x, m[l + 1]), m[l + 1])
            for blk in self.enc_blocks[l]:
                x = blk(batch, x)
            skips.append(x)

        # decoder: levels 4 -> 0, concatenating the skips of levels 3..0
        for s in range(4):
            lvl = 4 - s
            x = self.up_convs[s](batch, x, m[lvl - 1].shape)
            x = relu_masked(self.up_norms[s](x, m[lvl - 1]), m[lvl - 1])
            x = torch.cat([x, skips[lvl - 1]], dim=-1)
            for blk in self.dec_blocks[s]:
                x = blk(batch, x)

        return self.final(x)


class Res16UNet14(Res16UNetBase):
    LAYERS = (1, 1, 1, 1, 1, 1, 1, 1)


class Res16UNet18(Res16UNetBase):
    LAYERS = (2, 2, 2, 2, 2, 2, 2, 2)


class Res16UNet34(Res16UNetBase):
    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)


class Res16UNet50(Res16UNetBase):
    BLOCK = Bottleneck
    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)


class Res16UNet101(Res16UNetBase):
    BLOCK = Bottleneck
    LAYERS = (2, 3, 4, 23, 2, 2, 2, 2)


class Res16UNet14A(Res16UNet14):
    PLANES = (32, 64, 128, 256, 128, 128, 96, 96)


class Res16UNet14A2(Res16UNet14A):
    LAYERS = (1, 1, 1, 1, 2, 2, 2, 2)


class Res16UNet14B(Res16UNet14):
    PLANES = (32, 64, 128, 256, 128, 128, 128, 128)


class Res16UNet14B2(Res16UNet14B):
    LAYERS = (1, 1, 1, 1, 2, 2, 2, 2)


class Res16UNet14B3(Res16UNet14B):
    LAYERS = (2, 2, 2, 2, 1, 1, 1, 1)


class Res16UNet14C(Res16UNet14):
    PLANES = (32, 64, 128, 256, 192, 192, 128, 128)


class Res16UNet14D(Res16UNet14):
    PLANES = (32, 64, 128, 256, 384, 384, 384, 384)


class Res16UNet18A(Res16UNet18):
    PLANES = (32, 64, 128, 256, 128, 128, 96, 96)


class Res16UNet18B(Res16UNet18):
    PLANES = (32, 64, 128, 256, 128, 128, 128, 128)


class Res16UNet18D(Res16UNet18):
    PLANES = (32, 64, 128, 256, 384, 384, 384, 384)


class Res16UNet34A(Res16UNet34):
    PLANES = (32, 64, 128, 256, 256, 128, 64, 64)


class Res16UNet34B(Res16UNet34):
    PLANES = (32, 64, 128, 256, 256, 128, 64, 32)


class Res16UNet34C(Res16UNet34):
    PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
