"""Kernel K1: the sparse conv forward on the H100.

Counterpart of `csn_tpu/core/window_conv.py`, whose `window_conv_fwd` ran
the forward as a Pallas TPU kernel over windowed one-hot gathers and job
worklists. The TPU needed those because its row gathers were slow; the CUDA
kernel (`csn_tpu_torch/csrc/sparse_conv.cu`) gathers rows straight from the
kernel map: one block per tile of output rows x output channels, f32
accumulation over all offsets in registers, one store in the activation
dtype. Its plain version is `csn_tpu_torch.core.conv.conv_plain`.
"""

from __future__ import annotations

import torch

from csn_tpu_torch import kernels


def sparse_conv_fwd(feats: torch.Tensor, kmap: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Launch K1: feats [N_in, Cin], kmap [K, N_out] int32 (sentinel N_in),
    weights [K, Cin, Cout] of the feats' dtype -> [N_out, Cout]."""
    what = "sparse_conv_fwd"
    kernels.require_cuda(what, feats, kmap, weights)
    if feats.dim() != 2 or kmap.dim() != 2 or weights.dim() != 3:
        raise ValueError(f"{what}: want feats [N, Cin], kmap [K, N_out], "
                         f"weights [K, Cin, Cout]; got {tuple(feats.shape)}, "
                         f"{tuple(kmap.shape)}, {tuple(weights.shape)}")
    n_in, cin = feats.shape
    n_off, n_out = kmap.shape
    if weights.shape[:2] != (n_off, cin):
        raise ValueError(f"{what}: weights {tuple(weights.shape)} do not fit "
                         f"{n_off} offsets x Cin {cin}")
    if kmap.dtype != torch.int32:
        raise TypeError(f"{what}: kmap must be int32, got {kmap.dtype}")
    if weights.dtype != feats.dtype:
        raise TypeError(f"{what}: weights {weights.dtype} != feats "
                        f"{feats.dtype}")
    cout = weights.shape[2]
    out = torch.empty((n_out, cout), dtype=feats.dtype, device=feats.device)
    code = kernels.library().csn_sparse_conv_fwd(
        kernels.dtype_code(feats), feats.data_ptr(), kmap.data_ptr(),
        weights.data_ptr(), out.data_ptr(), n_in, n_out, n_off, cin, cout,
        kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return out
