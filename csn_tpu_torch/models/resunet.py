"""ResUNet family (4-level sparse U-Nets).

Counterpart of `csn_tpu/models/resunet.py` (mirror of
`MinkowskiNet/models/resunet.py`, MinkUNetBase): stem conv + block at level
0, three k2/s2 downs with residual stages, three k2/s2 transpose ups with
skip concatenations, 2-layer 1x1 head whose 512-wide hidden layer has a
BatchNorm momentum of its own (0.1). Variants as `resunet.py:193-242` of the
reference. Module attributes follow the flax names.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from csn_tpu_torch.core.pyramid import MapSpec
from csn_tpu_torch.models.blocks import BasicBlock, BasicBlockINBN, Bottleneck
from csn_tpu_torch.models.layers import (
    Conv1x1, MaskedBatchNorm, Norm, NormType, SparseConv, SparseNet,
    relu_masked,
)
from csn_tpu_torch.models.res16unet import block_stage

HEAD_DIM = 512


class ResUNetBase(SparseNet):
    BLOCK = BasicBlock
    PLANES = (64, 128, 256, 512, 256, 128, 128)
    LAYERS = (2, 2, 2, 2, 2, 2)
    INIT_DIM = 64
    NORM_TYPE = NormType.BATCH_NORM

    @classmethod
    def num_levels(cls) -> int:
        return 4

    @classmethod
    def pyramid_requirements(cls, conv1_kernel_size: int = 5
                             ) -> Tuple[MapSpec, ...]:
        maps = [MapSpec("same", 0, conv1_kernel_size)]
        maps += [MapSpec("same", l, 3) for l in range(4)]
        maps += [MapSpec("down", l, 2) for l in range(3)]
        maps += [MapSpec("up", l, 2) for l in range(3)]
        return tuple(dict.fromkeys(maps))  # a k3 stem repeats same0k3

    def __init__(self, out_channels: int, conv1_kernel_size: int = 5,
                 bn_momentum: float = 0.02, compute_dtype: str = "float32",
                 in_channels: int = 3):
        super().__init__(out_channels, compute_dtype)
        nt, bm = self.NORM_TYPE, bn_momentum
        P, L, D = self.PLANES, self.LAYERS, self.INIT_DIM
        self.conv0 = SparseConv(in_channels, D, f"same0k{conv1_kernel_size}",
                                input_grad=False)
        self.norm0 = Norm(nt, D, bm)
        self.block0 = block_stage(self.BLOCK, D, P[0], 0, L[0], nt, bm)
        self.down_convs = nn.ModuleList(
            SparseConv(P[l], P[l], f"down{l}k2") for l in range(3))
        self.down_norms = nn.ModuleList(Norm(nt, P[l], bm) for l in range(3))
        self.enc_blocks = nn.ModuleList(
            block_stage(self.BLOCK, P[l], P[l + 1], l + 1, L[l + 1], nt, bm)
            for l in range(3))
        up_in = (P[3], P[4], P[5])           # width entering up conv s
        self.up_convs = nn.ModuleList(
            SparseConv(up_in[s], P[4 + s], f"up{2 - s}k2") for s in range(3))
        self.up_norms = nn.ModuleList(
            Norm(nt, P[4 + s], bm) for s in range(3))
        # decoder blocks after the concatenations at levels 2 and 1; the
        # level-0 concatenation goes straight to the head
        self.dec_blocks = nn.ModuleList(
            block_stage(self.BLOCK, P[4 + s] + P[2 - s], P[4 + s], 2 - s,
                        L[4 + s], nt, bm)
            for s in range(2))
        self.final_fc = Conv1x1(P[6] + P[0], HEAD_DIM)
        self.final_norm = MaskedBatchNorm(HEAD_DIM, momentum=0.1)
        self.final_norm.own_momentum = True
        self.final_out = Conv1x1(HEAD_DIM, out_channels, f32=True)

    def forward(self, batch, keys: Sequence = (),
                generator: Optional[torch.Generator] = None):
        self._no_keys(keys)
        m = batch.masks
        x = self.conv0(batch, batch.vox_feats.to(self.compute_dtype),
                       m[0].shape)
        x = relu_masked(self.norm0(x, m[0]), m[0])
        for blk in self.block0:
            x = blk(batch, x)

        skips = [x]
        for l in range(3):
            x = self.down_convs[l](batch, x, m[l + 1].shape)
            x = relu_masked(self.down_norms[l](x, m[l + 1]), m[l + 1])
            for blk in self.enc_blocks[l]:
                x = blk(batch, x)
            if l < 2:
                skips.append(x)

        for s in range(3):
            lvl = 3 - s
            x = self.up_convs[s](batch, x, m[lvl - 1].shape)
            x = relu_masked(self.up_norms[s](x, m[lvl - 1]), m[lvl - 1])
            x = torch.cat([x, skips[lvl - 1]], dim=-1)
            if s < 2:
                for blk in self.dec_blocks[s]:
                    x = blk(batch, x)

        x = relu_masked(self.final_norm(self.final_fc(x), m[0]), m[0])
        return self.final_out(x).float()


class ResUNet14(ResUNetBase):
    LAYERS = (1, 1, 1, 1, 1, 1)


class ResUNet18(ResUNetBase):
    LAYERS = (2, 2, 2, 2, 2, 2)


class ResUNet18INBN(ResUNet18):
    """`resunet.py:203-205`."""

    NORM_TYPE = NormType.INSTANCE_BATCH_NORM
    BLOCK = BasicBlockINBN


class ResUNet34(ResUNetBase):
    LAYERS = (3, 4, 6, 3, 2, 2)


class ResUNet50(ResUNetBase):
    BLOCK = Bottleneck
    LAYERS = (3, 4, 6, 3, 2, 2)


class ResUNet101(ResUNetBase):
    BLOCK = Bottleneck
    LAYERS = (3, 4, 23, 3, 2, 2)


class ResUNet14D(ResUNet14):
    PLANES = (64, 128, 256, 512, 512, 512, 512)


class ResUNet18D(ResUNet18):
    PLANES = (64, 128, 256, 512, 512, 512, 512)


class ResUNet34D(ResUNet34):
    PLANES = (64, 128, 256, 512, 512, 512, 512)


class ResUNet34E(ResUNet34):
    INIT_DIM = 32
    PLANES = (32, 64, 128, 256, 128, 64, 64)


class ResUNet34F(ResUNet34):
    INIT_DIM = 32
    PLANES = (32, 64, 128, 256, 128, 64, 32)
