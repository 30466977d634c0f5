"""Building blocks over the sparse voxel batches.

Counterpart of `csn_tpu/models/layers.py`. Features flow as `[B, L, C]` per
stride level with a `[B, L]` bool mask; convolutions take their kernel maps
by name from a `TorchVoxelBatch`. Parameters keep the JAX package's
layouts: sparse-conv kernels `[K, Cin, Cout]`, norm `scale`/`bias` and the
running `mean`/`var` buffers per channel.
"""

from __future__ import annotations

import enum
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from csn_tpu_torch.core.conv import gather_rows, sparse_conv, \
    transpose_map_name


class NormType(enum.Enum):
    """Mirror of `models/modules/common.py:7-11` of the reference."""

    BATCH_NORM = 0
    INSTANCE_NORM = 1
    INSTANCE_BATCH_NORM = 2
    LAYER_NORM = 3


class SparseConv(nn.Module):
    """Sparse (possibly strided or transposed) convolution over the kernel
    map `map_name` ('sameNkK', 'downNkK': level N -> N+1, 'upNkK': N+1 ->
    N). The caller passes features of the map's source level and the
    destination level's [B, L] shape. The backward gathers over the
    transpose map the batch carries (`transpose_map_name`).
    `input_grad=False` (a stem conv on raw input data, whose d_feats has no
    consumer) makes the backward compute dW only."""

    def __init__(self, in_channels: int, features: int, map_name: str,
                 use_bias: bool = False, input_grad: bool = True):
        super().__init__()
        self.map_name = map_name
        self.input_grad = input_grad
        ksize = int(map_name.rsplit("k", 1)[1])
        self.kernel = nn.Parameter(torch.empty(ksize ** 3, in_channels,
                                               features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """ME-style uniform(-s, s), s = 1/sqrt(Cin * K); bias zeros."""
        k, cin, _ = self.kernel.shape
        s = 1.0 / (cin * k) ** 0.5
        with torch.no_grad():
            self.kernel.uniform_(-s, s, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, batch, x: torch.Tensor,
                out_shape: Tuple[int, int]) -> torch.Tensor:
        b, l_in, cin = x.shape
        t_name, mirror = transpose_map_name(self.map_name)
        feats = x.reshape(b * l_in, cin)
        if not self.input_grad:
            feats = feats.detach()
        out = sparse_conv(feats, batch.kmaps[self.map_name], self.kernel,
                          batch.kmaps.get(t_name), mirror)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out.reshape(out_shape[0], out_shape[1], -1)


class Conv1x1(nn.Module):
    """Pointwise convolution == per-voxel Linear. Computes in the activation
    dtype; `f32=True` casts the input up so a classifier head runs in
    f32."""

    def __init__(self, in_channels: int, features: int, f32: bool = False,
                 use_bias: bool = True):
        super().__init__()
        self.f32 = f32
        self.linear = nn.Linear(in_channels, features, bias=use_bias)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """variance_scaling(1/3, fan_in, uniform) = uniform(+-1/sqrt(fan_in));
        bias zeros (the flax defaults of the JAX package)."""
        s = 1.0 / self.linear.in_features ** 0.5
        with torch.no_grad():
            self.linear.weight.uniform_(-s, s, generator=generator)
            if self.linear.bias is not None:
                self.linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.f32:
            x = x.float()
        bias = self.linear.bias
        return F.linear(x, self.linear.weight.to(x.dtype),
                        None if bias is None else bias.to(x.dtype))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid voxels of the whole batch
    (ME.MinkowskiBatchNorm). It is the port's `Norm` (BATCH_NORM, the norm
    of the HRNet models).

    Train mode (`self.training`): one-pass f32 statistics over the valid
    rows, s1 = sum(x), s2 = sum(x * x), n = max(#valid, 1), mean = s1 / n,
    var = max(s2 / n - mean^2, 0); the running buffers are updated IN PLACE
    (under no_grad) with torch momentum semantics, running <- (1 - m) *
    running + m * batch, m = 0.02, tracking the unbiased variance
    var * n / max(n - 1, 1). Eval mode uses the running statistics. Either
    way the statistics fold into f32 per-channel coefficients applied in the
    activation dtype, y = x * inv + beta, and padded rows are zeroed."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.02):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            m = mask.float()
            n = m.sum().clamp(min=1.0)
            xm = xf * m[..., None]
            s1 = xm.sum(dim=(0, 1))
            s2 = (xf * xm).sum(dim=(0, 1))
            mean = s1 / n
            var = (s2 / n - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                mom = self.momentum
                self.mean.copy_((1.0 - mom) * self.mean + mom * mean)
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                self.var.copy_((1.0 - mom) * self.var + mom * unbiased)
        else:
            mean, var = self.mean.float(), self.var.float()
        inv = torch.rsqrt(var + self.eps) * self.scale.float()
        beta = self.bias.float() - mean * inv
        y = x * inv.to(x.dtype) + beta.to(x.dtype)
        return torch.where(mask[..., None], y, torch.zeros((), dtype=y.dtype,
                                                           device=y.device))


class MaskedInstanceNorm(nn.Module):
    """Per-shape, per-channel normalization over the valid voxels
    (ME.MinkowskiInstanceNorm): one-pass f32 statistics per shape, folded
    to one multiply-add in the activation dtype; the same in train and eval
    mode."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        m = mask.float()[..., None]
        n = m.sum(dim=1, keepdim=True).clamp(min=1.0)
        xm = xf * m
        mean = xm.sum(dim=1, keepdim=True) / n
        var = ((xf * xm).sum(dim=1, keepdim=True) / n
               - mean * mean).clamp(min=0.0)
        inv = torch.rsqrt(var + self.eps) * self.scale.float()
        beta = self.bias.float() - mean * inv
        y = x * inv.to(x.dtype) + beta.to(x.dtype)
        return torch.where(mask[..., None], y, torch.zeros((), dtype=y.dtype,
                                                           device=y.device))


class InstanceBatchNorm(MaskedBatchNorm):
    """INSTANCE_BATCH_NORM: the instance norm `inst`, then this batch
    norm."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.02):
        super().__init__(channels, eps, momentum)
        self.inst = MaskedInstanceNorm(channels)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return super().forward(self.inst(x, mask), mask)


class SparseLayerNorm(nn.Module):
    """Per-voxel LayerNorm over the channels (`models/modules/common.py:
    29-58` of the reference): f32 statistics, eps 1e-5, the output back in
    the activation dtype, padded rows zeroed."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale.float(),
                         self.bias.float(), self.eps).to(x.dtype)
        return torch.where(mask[..., None], y, torch.zeros((), dtype=y.dtype,
                                                           device=y.device))


def Norm(norm_type: NormType, channels: int,
         momentum: float = 0.02) -> nn.Module:
    """The norm module of `norm_type` (mirror of `get_norm`,
    `models/modules/common.py:14-26` of the reference); each is called as
    `norm(x, mask)`."""
    if norm_type == NormType.BATCH_NORM:
        return MaskedBatchNorm(channels, momentum=momentum)
    if norm_type == NormType.INSTANCE_NORM:
        return MaskedInstanceNorm(channels)
    if norm_type == NormType.INSTANCE_BATCH_NORM:
        return InstanceBatchNorm(channels, momentum=momentum)
    if norm_type == NormType.LAYER_NORM:
        return SparseLayerNorm(channels)
    raise ValueError(norm_type)


def sum_pool(batch, x: torch.Tensor, map_name: str,
             out_shape: Tuple[int, int]) -> torch.Tensor:
    """Sum pooling over a down kernel map (ME.MinkowskiSumPooling): each
    destination voxel sums the source rows its map column names; sentinel
    entries add 0."""
    b, l_in, c = x.shape
    rows = gather_rows(x.reshape(b * l_in, c), batch.kmaps[map_name])
    return rows.sum(dim=0).reshape(out_shape[0], out_shape[1], c)


def global_avg_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L, C] -> [B, C] masked mean, accumulated and returned in f32."""
    m = mask.float()[..., None]
    n = m.sum(dim=1).clamp(min=1.0)
    return (x.float() * m).sum(dim=1) / n


def global_max_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L, C] -> [B, C] masked max (padded rows count as the dtype's
    lowest value)."""
    neg = torch.finfo(x.dtype).min
    return torch.where(mask[..., None], x,
                       torch.full((), neg, dtype=x.dtype,
                                  device=x.device)).amax(dim=1)


def relu_masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], F.relu(x),
                       torch.zeros((), dtype=x.dtype, device=x.device))


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SparseNet(nn.Module):
    """What the trainers ask of a plain segmentation model beside `forward`
    (the Res16UNet, ResUNet and ResNet families): the activation dtype, the
    seeded init, and the `--bn_momentum` setter, which leaves a norm with a
    momentum of its own (`own_momentum`) alone."""

    def __init__(self, out_channels: int, compute_dtype: str = "float32"):
        super().__init__()
        self.out_channels = out_channels
        self.compute_dtype = DTYPES[compute_dtype]

    def set_bn_momentum(self, momentum: float) -> None:
        for m in self.modules():
            if isinstance(m, MaskedBatchNorm) \
                    and not getattr(m, "own_momentum", False):
                m.momentum = momentum

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init of every conv, pointwise conv and norm."""
        for m in self.modules():
            if isinstance(m, (SparseConv, Conv1x1, MaskedBatchNorm,
                              MaskedInstanceNorm, SparseLayerNorm)):
                m.reset_parameters(generator)

    def _no_keys(self, keys) -> None:
        if len(keys):
            raise ValueError(f"{type(self).__name__} takes no key batches")
