"""Sparse convolution over precomputed kernel maps, forward and backward.

Counterpart of `csn_tpu/core/conv.py`. The kernel map is an int32 table
`[K_off, N_out]` of source-row indices into the flattened `[N_in]` axis,
sentinel `N_in` for "no neighbour"; weights are `[K_off, Cin, Cout]` in the
offset order of `MapSpec.offsets`. `same`, `down` and `up` convolutions all
reduce to this one primitive; only the kernel map differs.

The backward never scatters (the contract of `sparse_conv_tvjp`): given the
transpose map `kmap_t [K_off, N_in]` (sentinel `N_out`; the up map of a
down conv and vice versa, the map itself with mirrored offsets for a
same-level conv), d_feats is a forward conv of the output gradient over
`kmap_t` with the paired weights transposed, and dW is the gather identity
`dW_t[k] = feats^T . gather(g, kmap_t[k])`.

`SparseConvFn` runs the CUDA kernels (core/window_conv.py: K1 forward and
d_feats, `sparse_conv_dw` for dW) for CUDA tensors and the plain versions
`conv_plain` / `conv_bwd_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def transpose_map_name(map_name: str) -> Tuple[str, bool]:
    """Transpose kernel-map name and weight-mirror flag for the gather
    backward: a same-level odd kernel is its own transpose with mirrored
    offsets; down and up maps of equal kernel size transpose each other."""
    if map_name.startswith("same"):
        return map_name, True
    if map_name.startswith("down"):
        return "up" + map_name[4:], False
    if map_name.startswith("up"):
        return "down" + map_name[2:], False
    raise ValueError(map_name)


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


def conv_bwd_plain(feats: torch.Tensor, g: torch.Tensor, kmap_t: torch.Tensor,
                   weights: torch.Tensor, mirror: bool, input_grad: bool
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain version of the backward (`_tvjp_bwd`): one batched gather of
    the output gradient over the transpose map serves both gradients,
        d_feats = sum_k gather(g, kmap_t[k]) . W_pair[k]^T,
        dW_t[k] = feats^T . gather(g, kmap_t[k]),
    with W_pair = W reversed over offsets for a mirrored (same-level) map,
    and dW = dW_t reversed back. f32 math; d_feats in the feats' dtype
    (None without `input_grad`), dW in the weights' dtype."""
    w_pair = weights.flip(0) if mirror else weights
    gg = gather_rows(g, kmap_t).float()              # [K, N_in, Cout]
    d_feats = None
    if input_grad:
        d_feats = torch.einsum("knd,kcd->nc", gg, w_pair.float()).to(
            feats.dtype)
    d_w_t = torch.einsum("nc,knd->kcd", feats.float(), gg)
    d_w = d_w_t.flip(0) if mirror else d_w_t
    return d_feats, d_w.to(weights.dtype)


def conv_bwd_kernels(feats: torch.Tensor, g: torch.Tensor,
                     kmap_t: torch.Tensor, weights: torch.Tensor,
                     mirror: bool, input_grad: bool
                     ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """`conv_bwd_plain` on the CUDA kernels: d_feats is K1 over the
    transpose map with W_pair[k]^T in the output gradient's dtype, dW_t is
    `sparse_conv_dw` (f32). Same contract and dtypes as the plain version."""
    d_feats = None
    if input_grad:
        w_pair = weights.flip(0) if mirror else weights
        d_feats = window_conv.sparse_conv_fwd(
            g, kmap_t, w_pair.transpose(1, 2).to(g.dtype).contiguous()
        ).to(feats.dtype)
    d_w_t = window_conv.sparse_conv_dw(feats, g, kmap_t)
    d_w = d_w_t.flip(0) if mirror else d_w_t
    return d_feats, d_w.to(weights.dtype)


class SparseConvFn(torch.autograd.Function):
    """The sparse conv with its gather backward (the custom VJP
    `sparse_conv_tvjp` of the JAX package). Takes the f32 weights and casts
    them to the activation dtype inside, so dW comes back in f32 while
    d_feats comes back in the feats' dtype. d_feats is skipped when the
    input needs no gradient (the stem conv on raw data)."""

    @staticmethod
    def forward(ctx, feats, weights, kmap, kmap_t, mirror: bool):
        w = weights.to(feats.dtype)
        if feats.device.type == "cpu":
            out = conv_plain(feats, kmap, w)
        else:
            out = window_conv.sparse_conv_fwd(feats, kmap, w)
        ctx.save_for_backward(feats, weights, kmap_t)
        ctx.mirror = mirror
        return out

    @staticmethod
    def backward(ctx, g):
        feats, weights, kmap_t = ctx.saved_tensors
        if kmap_t is None:
            raise RuntimeError("sparse conv backward needs the transpose map "
                               "kmap_t")
        bwd = conv_bwd_plain if g.device.type == "cpu" else conv_bwd_kernels
        d_feats, d_w = bwd(feats, g.contiguous(), kmap_t, weights,
                           ctx.mirror, ctx.needs_input_grad[0])
        return d_feats, d_w, None, None, None


def sparse_conv(feats: torch.Tensor, kmap: torch.Tensor,
                weights: torch.Tensor, kmap_t: Optional[torch.Tensor] = None,
                mirror: bool = False) -> torch.Tensor:
    """[N_in, Cin] features, [K, N_out] kernel map, [K, Cin, Cout] weights
    -> [N_out, Cout] in the features' dtype (weights are cast to it, as the
    TPU kernel casts its operands). Differentiable when the transpose map
    `kmap_t` (and `mirror` for a same-level map) is given."""
    return SparseConvFn.apply(feats, weights, kmap, kmap_t, mirror)
