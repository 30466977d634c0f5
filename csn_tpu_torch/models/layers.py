"""Building blocks over the sparse voxel batches.

Counterpart of `csn_tpu/models/layers.py`. Features flow as `[B, L, C]` per
stride level with a `[B, L]` bool mask; convolutions take their kernel maps
by name from a `TorchVoxelBatch`. Parameters keep the JAX package's
layouts: sparse-conv kernels `[K, Cin, Cout]`, norm `scale`/`bias` and the
running `mean`/`var` buffers per channel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from csn_tpu_torch.core.conv import sparse_conv, transpose_map_name


class SparseConv(nn.Module):
    """Sparse (possibly strided or transposed) convolution over the kernel
    map `map_name` ('sameNkK', 'downNkK': level N -> N+1, 'upNkK': N+1 ->
    N). The caller passes features of the map's source level and the
    destination level's [B, L] shape. The backward gathers over the
    transpose map the batch carries (`transpose_map_name`)."""

    def __init__(self, in_channels: int, features: int, map_name: str):
        super().__init__()
        self.map_name = map_name
        ksize = int(map_name.rsplit("k", 1)[1])
        self.kernel = nn.Parameter(torch.empty(ksize ** 3, in_channels,
                                               features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """ME-style uniform(-s, s), s = 1/sqrt(Cin * K)."""
        k, cin, _ = self.kernel.shape
        s = 1.0 / (cin * k) ** 0.5
        with torch.no_grad():
            self.kernel.uniform_(-s, s, generator=generator)

    def forward(self, batch, x: torch.Tensor,
                out_shape: Tuple[int, int]) -> torch.Tensor:
        b, l_in, cin = x.shape
        t_name, mirror = transpose_map_name(self.map_name)
        out = sparse_conv(x.reshape(b * l_in, cin),
                          batch.kmaps[self.map_name], self.kernel,
                          batch.kmaps.get(t_name), mirror)
        return out.reshape(out_shape[0], out_shape[1], -1)


class Conv1x1(nn.Module):
    """Pointwise convolution with bias == per-voxel Linear. Computes in the
    activation dtype; `f32=True` casts the input up so a classifier head
    runs in f32."""

    def __init__(self, in_channels: int, features: int, f32: bool = False):
        super().__init__()
        self.f32 = f32
        self.linear = nn.Linear(in_channels, features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """variance_scaling(1/3, fan_in, uniform) = uniform(+-1/sqrt(fan_in));
        bias zeros (the flax defaults of the JAX package)."""
        s = 1.0 / self.linear.in_features ** 0.5
        with torch.no_grad():
            self.linear.weight.uniform_(-s, s, generator=generator)
            self.linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.f32:
            x = x.float()
        return F.linear(x, self.linear.weight.to(x.dtype),
                        self.linear.bias.to(x.dtype))


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


def global_avg_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L, C] -> [B, C] masked mean, accumulated and returned in f32."""
    m = mask.float()[..., None]
    n = m.sum(dim=1).clamp(min=1.0)
    return (x.float() * m).sum(dim=1) / n


def relu_masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], F.relu(x),
                       torch.zeros((), dtype=x.dtype, device=x.device))
