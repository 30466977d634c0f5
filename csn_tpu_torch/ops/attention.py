"""Self-/cross-shape attention primitives.

Counterpart of `csn_tpu/ops/attention.py`: post-norm residual multi-head
attention with no-bias q/k/v/out projections, temperature sqrt(d_k),
dropout on the attention weights and on the output projection in train
mode, a residual add and LayerNorm(eps=1e-6) in f32, over padded point sets
`[B, L, d]` with bool masks.

The attention core runs `FlashAttentionFn` (kernel K2 and its backward,
ops/flash.py) for CUDA tensors and the plain version
`scaled_dot_product_attention`, differentiated by autograd, for CPU tensors.
Both drop the same attention weights for the same seed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from csn_tpu_torch.ops.flash import (
    NEG_INF, FlashAttentionFn, dropout_keep_mask,
)

# f32 elements of one plain score block: the plain version walks the batch
# in chunks so that [b, H, Lq, Lk] stays near 1 GiB at the main path's
# [16, 4, 5632, 5632]
_SCORE_BLOCK = 1 << 28


def scaled_dot_product_attention(
    q: torch.Tensor,                          # [B, H, Lq, Dk]
    k: torch.Tensor,                          # [B, H, Lk, Dk]
    v: torch.Tensor,                          # [B, H, Lk, Dv]
    kv_mask: Optional[torch.Tensor] = None,   # [B, Lk] bool
    temperature: Optional[float] = None,
    *,
    dropout: float = 0.0,
    seed: Optional[int] = None,
    return_lse: bool = False,
):
    """Plain masked softmax attention: scores of (q / temperature) and k in
    f32, masked keys at NEG_INF, softmax, with dropout > 0 the probabilities
    dropped by the mask of `seed` (`ops.flash.dropout_keep_mask`) and the
    kept ones scaled by 1/keep (torch's dropout(softmax(s))), probabilities
    in v's dtype times v accumulated in f32. Returns [B, H, Lq, Dv] in v's
    dtype, and with `return_lse` also the (undropped) f32 log-sum-exp rows
    [B, H, Lq]. Differentiable by autograd."""
    if temperature is None:
        temperature = float(q.shape[-1]) ** 0.5
    if dropout > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    chunk = max(1, _SCORE_BLOCK // max(1, H * Lq * Lk))
    outs, lses = [], []
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        scores = torch.matmul((q[sl] / temperature).float(),
                              k[sl].float().transpose(-1, -2))
        if kv_mask is not None:
            scores = scores.masked_fill(~kv_mask[sl, None, None, :], NEG_INF)
        attn = torch.softmax(scores, dim=-1)
        if dropout > 0.0:
            keep = dropout_keep_mask(seed, dropout, tuple(attn.shape),
                                     attn.device, batch_offset=b0)
            attn = torch.where(keep, attn * (1.0 / (1.0 - dropout)),
                               torch.zeros((), device=attn.device))
            del keep
        outs.append(torch.matmul(attn.to(v.dtype).float(), v[sl].float())
                    .to(v.dtype))
        if return_lse:
            lses.append(torch.logsumexp(scores, dim=-1))
        del scores, attn
    out = torch.cat(outs, dim=0)
    return (out, torch.cat(lses, dim=0)) if return_lse else out


def attention_core(q, k, v, kv_mask, q_mask, temperature: float,
                   dropout: float = 0.0, seed: Optional[int] = None):
    """[B, H, L, D] attention: K2 and its backward for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return scaled_dot_product_attention(q, k, v, kv_mask, temperature,
                                            dropout=dropout, seed=seed)
    return FlashAttentionFn.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), kv_mask, q_mask,
                                  temperature, dropout, seed)


def draw_seed(generator: torch.Generator) -> int:
    """One 62-bit seed from a CPU generator: a host draw, no device sync."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator))


class MultiHeadAttention(nn.Module):
    """Post-norm residual MHA (`MultiHeadAttention` of the JAX package).
    `nn.Linear` weights are `[out, in]`: the converter transposes the flax
    `[in, out]` kernels. Projections run in the activation dtype, the
    LayerNorm in f32; the result is cast back. Padded query rows are junk;
    callers mask them.

    In train mode with `dropout` > 0 the call needs a CPU `generator`: it
    draws one seed for the attention-weight dropout (in K2, or the plain
    version on the CPU) and one that seeds, on the output's device, the
    generator of the output-projection dropout."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 dropout: float = 0.1):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dropout = dropout
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Projections at uniform(+-sqrt(3/fan_in)) (the variance of flax's
        lecun_normal), LayerNorm at identity."""
        with torch.no_grad():
            for lin in (self.w_qs, self.w_ks, self.w_vs, self.fc):
                s = (3.0 / lin.in_features) ** 0.5
                lin.weight.uniform_(-s, s, generator=generator)
            self.layer_norm.reset_parameters()

    def forward(self, q, k, v, kv_mask=None, q_mask=None,
                generator: Optional[torch.Generator] = None):
        b, lq, _ = q.shape
        adt = q.dtype
        residual = q
        drop = self.dropout if self.training else 0.0
        if drop > 0.0 and generator is None:
            raise ValueError("MultiHeadAttention in train mode with dropout "
                             "needs a generator")

        def proj(lin, x, n, d):
            return F.linear(x, lin.weight.to(adt)).reshape(
                b, x.shape[1], n, d).transpose(1, 2)

        qh = proj(self.w_qs, q, self.n_head, self.d_k)
        kh = proj(self.w_ks, k, self.n_head, self.d_k)
        vh = proj(self.w_vs, v, self.n_head, self.d_v)
        out = attention_core(qh, kh, vh, kv_mask, q_mask,
                             float(self.d_k) ** 0.5, drop,
                             draw_seed(generator) if drop > 0.0 else None)
        out = out.transpose(1, 2).reshape(b, lq, self.n_head * self.d_v)
        out = F.linear(out, self.fc.weight.to(adt))
        if drop > 0.0:  # output-projection dropout, plain torch
            g = torch.Generator(device=out.device)
            g.manual_seed(draw_seed(generator))
            keep = torch.rand(out.shape, generator=g,
                              device=out.device) < 1.0 - drop
            out = torch.where(keep, out / (1.0 - drop),
                              torch.zeros((), dtype=adt, device=out.device))
        out = out + residual
        out = F.layer_norm(out.float(), (out.shape[-1],),
                           self.layer_norm.weight, self.layer_norm.bias,
                           self.layer_norm.eps)
        return out.to(adt)


def compatibility_softmax(query_glob: torch.Tensor, keys_glob: torch.Tensor,
                          temperature: float = 1.0) -> torch.Tensor:
    """Softmax over [self]+K of the similarities of query_glob [B, D] with
    keys_glob [B, K+1, D], divided by `temperature`. Returns [B, K+1]."""
    sim = torch.einsum("bd,bkd->bk", query_glob, keys_glob) / temperature
    return torch.softmax(sim, dim=-1)
