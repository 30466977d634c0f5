"""Sparse convolution over precomputed kernel maps (forward).

Counterpart of `csn_tpu/core/conv.py`. The kernel map is an int32 table
`[K_off, N_out]` of source-row indices into the flattened `[N_in]` axis,
sentinel `N_in` for "no neighbour"; weights are `[K_off, Cin, Cout]` in the
offset order of `MapSpec.offsets`. `same`, `down` and `up` convolutions all
reduce to this one primitive; only the kernel map differs.

`sparse_conv` launches the CUDA kernel (core/window_conv.py) for CUDA
tensors and runs the plain version `conv_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from csn_tpu_torch.core import window_conv


def gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [N, C], idx [...] int with sentinel >= N -> rows [..., C], with
    zero rows for the sentinel (JAX's `mode='fill'` gather)."""
    n = feats.shape[0]
    valid = (idx >= 0) & (idx < n)
    rows = feats[torch.where(valid, idx, 0).long()]
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))


def conv_plain(feats: torch.Tensor, kmap: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Plain version of the sparse conv forward (`_conv_impl`): gather with
    the sentinel -> zero rows, sum over offsets of `g_k @ W[k]` accumulated
    in f32, cast back to the activation dtype."""
    n_out = kmap.shape[1]
    out = torch.zeros((n_out, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    w32 = weights.float()
    for k in range(kmap.shape[0]):
        out += gather_rows(feats, kmap[k]).float() @ w32[k]
    return out.to(feats.dtype)


def sparse_conv(feats: torch.Tensor, kmap: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """[N_in, Cin] features, [K, N_out] kernel map, [K, Cin, Cout] weights
    -> [N_out, Cout] in the features' dtype (weights are cast to it, as the
    TPU kernel casts its operands)."""
    weights = weights.to(feats.dtype)
    if feats.device.type == "cpu":
        return conv_plain(feats, kmap, weights)
    return window_conv.sparse_conv_fwd(feats, kmap, weights)
