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

`SparseConvFn` dispatches on `window_conv.dyng_mode()` (`CSN_DYNG`, read at
every call). Modes 0 and 1: the CUDA kernels K1 (forward and d_feats) and
`sparse_conv_dw` (dW) for CUDA tensors, the plain versions `conv_plain` /
`conv_bwd_plain` for CPU tensors. Modes 2 and 3, the im2col form (one
product over the flattened axis K*Cin forward; one gathered-gradient matrix
GG [N, K*Cout] serving d_feats and the whole dW backward): the kernels
`sparse_conv_im2col_fwd` / `sparse_conv_im2col_bwd` for CUDA tensors,
`conv_im2col_plain` / `conv_im2col_bwd_plain` for CPU tensors.
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


IM2COL_PLAIN_ROWS = 8192   # rows per product of the plain im2col versions


def im2col_rows(src: torch.Tensor, kmap: torch.Tensor, lo: int,
                hi: int) -> torch.Tensor:
    """Rows lo..hi of the im2col matrix [N_out, K * C] of `src` [N, C] over
    `kmap` [K, N_out]: offset k owns the column block k*C .. (k+1)*C."""
    rows = gather_rows(src, kmap[:, lo:hi])           # [K, n, C]
    return rows.transpose(0, 1).reshape(hi - lo, -1)


def stack_pair_transposed(w_pair: torch.Tensor) -> torch.Tensor:
    """[K, Cin, Cout] paired weights -> WT [K * Cout, Cin] with
    WT[k*Cout + d, c] = W_pair[k, c, d], the right operand of d_feats =
    GG @ WT."""
    k, cin, cout = w_pair.shape
    return w_pair.transpose(1, 2).reshape(k * cout, cin)


def unstack_dw(dw_flat: torch.Tensor, n_off: int) -> torch.Tensor:
    """dW_flat [Cin, K * Cout] = feats^T @ GG -> dW_t [K, Cin, Cout]."""
    cin = dw_flat.shape[0]
    return dw_flat.reshape(cin, n_off, -1).permute(1, 0, 2)


def conv_im2col_plain(feats: torch.Tensor, kmap: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Plain version of the im2col forward: IC [N_out, K * Cin] by gather,
    one product with weights.reshape(K * Cin, Cout) in f32, cast back to the
    activation dtype; IM2COL_PLAIN_ROWS rows at a time so that the widest
    level fits."""
    n_off, n_out = kmap.shape
    w_flat = weights.float().reshape(n_off * feats.shape[1], -1)
    out = torch.empty((n_out, w_flat.shape[1]), dtype=feats.dtype,
                      device=feats.device)
    for lo in range(0, n_out, IM2COL_PLAIN_ROWS):
        hi = min(lo + IM2COL_PLAIN_ROWS, n_out)
        out[lo:hi] = (im2col_rows(feats, kmap, lo, hi).float()
                      @ w_flat).to(feats.dtype)
    return out


def conv_im2col_bwd_plain(feats: torch.Tensor, g: torch.Tensor,
                          kmap_t: torch.Tensor, weights: torch.Tensor,
                          mirror: bool, input_grad: bool
                          ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain version of the fused im2col backward, the contract of
    `conv_bwd_plain`: GG [N_in, K * Cout] gathered once from g over the
    transpose map,
        d_feats = GG @ WT              (WT = `stack_pair_transposed(W_pair)`)
        dW_flat = feats^T @ GG         [Cin, K * Cout], f32, over all rows,
    dW_t = `unstack_dw(dW_flat)`, un-mirrored for a same-level map. The
    paired weights enter d_feats in the gradient's dtype, as the kernel
    reads them."""
    n_off, n_in = kmap_t.shape
    w_pair = weights.flip(0) if mirror else weights
    wt = stack_pair_transposed(w_pair.to(g.dtype)).float()
    d_feats = torch.empty_like(feats) if input_grad else None
    dw_flat = torch.zeros((feats.shape[1], n_off * g.shape[1]),
                          dtype=torch.float32, device=feats.device)
    for lo in range(0, n_in, IM2COL_PLAIN_ROWS):
        hi = min(lo + IM2COL_PLAIN_ROWS, n_in)
        gg = im2col_rows(g, kmap_t, lo, hi).float()
        if input_grad:
            d_feats[lo:hi] = (gg @ wt).to(feats.dtype)
        dw_flat += feats[lo:hi].float().t() @ gg
    d_w_t = unstack_dw(dw_flat, n_off)
    d_w = d_w_t.flip(0) if mirror else d_w_t
    return d_feats, d_w.to(weights.dtype)


def conv_im2col_bwd_kernels(feats: torch.Tensor, g: torch.Tensor,
                            kmap_t: torch.Tensor, weights: torch.Tensor,
                            mirror: bool, input_grad: bool
                            ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """`conv_im2col_bwd_plain` on the CUDA kernel `sparse_conv_im2col_bwd`.
    Same contract and dtypes as the plain version."""
    wt = None
    if input_grad:
        w_pair = weights.flip(0) if mirror else weights
        wt = stack_pair_transposed(w_pair.to(g.dtype)).contiguous()
    d_feats, dw_flat = window_conv.sparse_conv_im2col_bwd(
        feats, g, kmap_t, wt, dw_only=not input_grad)
    d_w_t = unstack_dw(dw_flat, kmap_t.shape[0])
    d_w = d_w_t.flip(0) if mirror else d_w_t
    return d_feats, d_w.to(weights.dtype).contiguous()


# (forward, backward) by [im2col form?][CUDA tensor?]
def _forward_fn(im2col: bool, cuda: bool):
    if im2col:
        return window_conv.sparse_conv_im2col_fwd if cuda \
            else conv_im2col_plain
    return window_conv.sparse_conv_fwd if cuda else conv_plain


def _backward_fn(im2col: bool, cuda: bool):
    if im2col:
        return conv_im2col_bwd_kernels if cuda else conv_im2col_bwd_plain
    return conv_bwd_kernels if cuda else conv_bwd_plain


class SparseConvFn(torch.autograd.Function):
    """The sparse conv with its gather backward (the custom VJP
    `sparse_conv_tvjp` of the JAX package). Takes the f32 weights and casts
    them to the activation dtype inside, so dW comes back in f32 while
    d_feats comes back in the feats' dtype. d_feats is skipped when the
    input needs no gradient (the stem conv on raw data). The backward
    takes the form (`CSN_DYNG`) its forward ran in."""

    @staticmethod
    def forward(ctx, feats, weights, kmap, kmap_t, mirror: bool):
        w = weights.to(feats.dtype)
        ctx.im2col = window_conv.dyng_mode() >= 2
        out = _forward_fn(ctx.im2col, feats.device.type != "cpu")(
            feats, kmap, w)
        ctx.save_for_backward(feats, weights, kmap_t)
        ctx.mirror = mirror
        return out

    @staticmethod
    def backward(ctx, g):
        feats, weights, kmap_t = ctx.saved_tensors
        if kmap_t is None:
            raise RuntimeError("sparse conv backward needs the transpose map "
                               "kmap_t")
        bwd = _backward_fn(ctx.im2col, g.device.type != "cpu")
        d_feats, d_w = bwd(feats, g.contiguous(), kmap_t, weights,
                           ctx.mirror, ctx.needs_input_grad[0])
        return d_feats, d_w, None, None, None


def conv_autograd_plain(feats: torch.Tensor, kmap: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """`conv_plain` written for autograd (the JAX package's `_conv_impl`
    under its own differentiation): the backward scatters through the
    gather's index, so it needs no transpose map."""
    w = weights.float()
    out = sum(gather_rows(feats, kmap[k]).float() @ w[k]
              for k in range(kmap.shape[0]))
    return out.to(feats.dtype)


def sparse_conv(feats: torch.Tensor, kmap: torch.Tensor,
                weights: torch.Tensor, kmap_t: Optional[torch.Tensor] = None,
                mirror: bool = False) -> torch.Tensor:
    """[N_in, Cin] features, [K, N_out] kernel map, [K, Cin, Cout] weights
    -> [N_out, Cout] in the features' dtype (weights are cast to it, as the
    TPU kernel casts its operands). With the transpose map `kmap_t` (and
    `mirror` for a same-level map) the backward is the gather backward of
    `SparseConvFn`. Without it a gradient is served on the CPU only, by the
    plain autograd path `conv_autograd_plain` (tests and tools); a CUDA
    tensor that needs a gradient without `kmap_t` raises."""
    if kmap_t is None and torch.is_grad_enabled() and (
            feats.requires_grad or weights.requires_grad):
        if feats.device.type != "cpu":
            raise ValueError(
                "sparse_conv: a gradient on a CUDA tensor needs the "
                "transpose map kmap_t (the backward kernels gather over it)")
        return conv_autograd_plain(feats, kmap, weights)
    return SparseConvFn.apply(feats, weights, kmap, kmap_t, mirror)
