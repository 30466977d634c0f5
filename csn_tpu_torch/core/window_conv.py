"""The sparse conv kernels on the H100: K1 (forward, and the backward's
d_feats over the transpose map) and `sparse_conv_dw` (the weight gradient).

Counterpart of `csn_tpu/core/window_conv.py`, whose `window_conv_fwd` and
`window_conv_bwd` ran the forward and the fused backward as Pallas TPU
kernels over windowed one-hot gathers and job worklists. The TPU needed
those because its row gathers were slow; the CUDA kernels gather rows
straight from the kernel map:

* K1 (`csn_tpu_torch/csrc/sparse_conv.cu`): one block per tile of output
  rows x output channels, f32 accumulation over all offsets in registers,
  one store in the activation dtype. Plain version:
  `csn_tpu_torch.core.conv.conv_plain`.
* `sparse_conv_dw` (`csn_tpu_torch/csrc/sparse_conv_bwd.cu`): one block per
  (channel tile, offset, row split), f32 partials per split summed by a
  second kernel in a fixed order. Plain version: the dW half of
  `csn_tpu_torch.core.conv.conv_bwd_plain`.
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


SMS = 132            # streaming multiprocessors of the H100 SXM
MIN_SPLIT_ROWS = 1024


def dw_splits(n_in: int, n_off: int, cin: int, cout: int) -> int:
    """Row splits S of the dW kernel: enough that the grid of (channel
    tiles x offsets x S) blocks puts about two on each SM, with at least
    MIN_SPLIT_ROWS rows per split and at most 64 splits."""
    tm = 16 if cin <= 16 else 64              # the kernel's channel tile
    blocks = -(-cin // tm) * -(-cout // 64) * n_off
    want = -(-2 * SMS // blocks)
    return max(1, min(want, 64, n_in // MIN_SPLIT_ROWS))


def sparse_conv_dw(feats: torch.Tensor, g: torch.Tensor,
                   kmap_t: torch.Tensor) -> torch.Tensor:
    """Launch the dW kernel: feats [N_in, Cin] and g [N_g, Cout] of one
    dtype, kmap_t [K, N_in] int32 (sentinel N_g) -> dW_t [K, Cin, Cout] f32,
    dW_t[k] = feats^T . gather(g, kmap_t[k])."""
    what = "sparse_conv_dw"
    kernels.require_cuda(what, feats, g, kmap_t)
    if feats.dim() != 2 or g.dim() != 2 or kmap_t.dim() != 2 \
            or kmap_t.shape[1] != feats.shape[0]:
        raise ValueError(f"{what}: want feats [N_in, Cin], g [N_g, Cout], "
                         f"kmap_t [K, N_in]; got {tuple(feats.shape)}, "
                         f"{tuple(g.shape)}, {tuple(kmap_t.shape)}")
    if kmap_t.dtype != torch.int32:
        raise TypeError(f"{what}: kmap_t must be int32, got {kmap_t.dtype}")
    if g.dtype != feats.dtype:
        raise TypeError(f"{what}: g {g.dtype} != feats {feats.dtype}")
    n_in, cin = feats.shape
    n_g, cout = g.shape
    n_off = kmap_t.shape[0]
    n_split = dw_splits(n_in, n_off, cin, cout)
    out = torch.empty((n_off, cin, cout), dtype=torch.float32,
                      device=feats.device)
    part = (torch.empty((n_split, n_off, cin, cout), dtype=torch.float32,
                        device=feats.device) if n_split > 1 else out)
    code = kernels.library().csn_sparse_conv_dw(
        kernels.dtype_code(feats), feats.data_ptr(), g.data_ptr(),
        kmap_t.data_ptr(), part.data_ptr(), out.data_ptr(), n_in, n_g, n_off,
        cin, cout, n_split, kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return out
