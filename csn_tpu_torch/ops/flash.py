"""Kernel K2 and its backward: masked flash attention on the H100, with
in-kernel attention dropout.

Counterpart of `csn_tpu/ops/flash.py`, whose `_flash_forward` and
`_flash_backward` ran the online-softmax attention and its gradient as
Pallas TPU kernels over sequential grid axes with VMEM scratch.

* Forward (`csn_tpu_torch/csrc/flash_attn.cu`): one block per (batch*head,
  64-query tile) loops over 64-key tiles, skipping query tiles with no valid
  query and key tiles with no valid key. Returns `out` and the f32
  log-sum-exp rows `lse`.
* Backward (`csn_tpu_torch/csrc/flash_attn_bwd.cu`): dQ, dK, dV from q, k,
  v, dO, `lse` and `delta = rowsum(dO * O)` (plain torch, as the JAX package
  computes it in XLA), in two deterministic passes (dK/dV per key tile, dQ
  per query tile) that skip the forward's tiles.
* Dropout: the mask is a function of (seed, batch*head, query row, key
  column) only, through the counter-based generator Philox4x32-10, written
  twice bit for bit: `philox4x32` here (torch int64 ops, the plain
  version's mask) and `csn::philox4x32` in `csrc/common.cuh`. Key column c
  of row r is kept when word c % 4 of Philox((c // 4, r, bh, 0), seed) is
  below floor(keep * 2^32). Forward, backward and the plain version drop
  the same entries whatever their tiling: the TPU kernel's `_drop_mask`
  records that a block-shaped mask with different forward and backward
  blocks gave a biased gradient that sent training to NaN.

The plain version is `csn_tpu_torch.ops.attention.scaled_dot_product_attention`
(its backward is autograd's). `FlashAttentionFn` is the autograd Function
over the two kernels; it takes CUDA tensors only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from csn_tpu_torch import kernels

NEG_INF = -1e30
HEAD_DIM = 64  # d_model 256 / 4 heads, the HRNet CSN heads

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x for x in [0, 2^32) held in int64,
    without overflowing int64: x is split in 16-bit halves."""
    a = m * (x & 0xFFFF)                  # < 2^48
    t = (a >> 16) + m * (x >> 16)         # (m * x) >> 16, < 2^49
    return t >> 16, ((t & 0xFFFF) << 16) | (a & 0xFFFF)


def philox4x32(counter: Sequence[torch.Tensor], key: Tuple[int, int]
               ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding 32-bit words: counter (c0, c1,
    c2, c3) broadcast together, key (k0, k1) Python ints. Returns the four
    output words (int64, in [0, 2^32)). Bit-identical to `csn::philox4x32`
    (csrc/common.cuh)."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(dropout: float) -> int:
    """floor(keep * 2^32), keep = 1 - dropout: a word below it is kept."""
    return min(int((1.0 - dropout) * 4294967296.0), _MASK32)


def dropout_keep_mask(seed: int, dropout: float, shape: Tuple[int, ...],
                      device=None, batch_offset: int = 0) -> torch.Tensor:
    """The attention-dropout keep mask [b, H, Lq, Lk] (bool) of batch rows
    batch_offset .. batch_offset + b - 1: entry (b, h, r, c) is kept when
    word c % 4 of Philox((c // 4, r, b * H + h, 0), (seed lo, seed hi)) is
    below `keep_threshold(dropout)`."""
    b, h, lq, lk = shape
    n4 = -(-lk // 4)
    i64 = dict(dtype=torch.int64, device=device)
    bh = ((torch.arange(b, **i64) + batch_offset)[:, None] * h
          + torch.arange(h, **i64))[:, :, None, None]
    rows = torch.arange(lq, **i64)[:, None]
    col4 = torch.arange(n4, **i64)
    words = philox4x32((col4, rows, bh, torch.zeros((), **i64)),
                       (seed & _MASK32, (seed >> 32) & _MASK32))
    bits = torch.stack(words, dim=-1).reshape(b, h, lq, 4 * n4)[..., :lk]
    return bits < keep_threshold(dropout)


def _drop_args(dropout: float, seed: Optional[int]):
    """(seed, thresh, inv_keep, use_drop) of the C launchers."""
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout {dropout} outside [0, 1)")
    if dropout == 0.0:
        return 0, 0, 1.0, 0
    if seed is None:
        raise ValueError("attention dropout needs a seed")
    return int(seed) & 0xFFFFFFFFFFFFFFFF, keep_threshold(dropout), \
        1.0 / (1.0 - dropout), 1


def _check_qkv(what, q, k, v):
    if q.dim() != 4 or k.shape[:2] != q.shape[:2] or v.shape != k.shape \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: want q [B, H, Lq, D], k and v [B, H, Lk, "
                         f"D]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[3] != HEAD_DIM:
        raise ValueError(f"{what}: head dim {q.shape[3]} != {HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: q, k, v dtypes differ")


def _masks(what, q, k, kv_mask, q_mask):
    B, _, Lq, _ = q.shape
    Lk = k.shape[2]
    if kv_mask is None:
        kv_mask = torch.ones((B, Lk), dtype=torch.bool, device=q.device)
    if q_mask is None:
        q_mask = torch.ones((B, Lq), dtype=torch.bool, device=q.device)
    if kv_mask.shape != (B, Lk) or q_mask.shape != (B, Lq):
        raise ValueError(f"{what}: masks {tuple(kv_mask.shape)}, "
                         f"{tuple(q_mask.shape)} do not fit B={B}, Lq={Lq}, "
                         f"Lk={Lk}")
    return (kv_mask.to(torch.bool).contiguous(),
            q_mask.to(torch.bool).contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    q_mask: Optional[torch.Tensor] = None,
                    temperature: float = 1.0, dropout: float = 0.0,
                    seed: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2: q [B, H, Lq, D], k and v [B, H, Lk, D], kv_mask [B, Lk]
    and q_mask [B, Lq] bool -> (out [B, H, Lq, D] in q's dtype, lse
    [B, H, Lq] f32). Rows whose q_mask is false are padding: junk by
    contract (zeros where a whole 64-row tile is padding). With dropout > 0
    the probabilities of the numerator are dropped by the mask of `seed`
    (`dropout_keep_mask`); `lse` stays undropped."""
    what = "flash_attn_fwd"
    _check_qkv(what, q, k, v)
    drop = _drop_args(dropout, seed)
    kv_mask, q_mask = _masks(what, q, k, kv_mask, q_mask)
    kernels.require_cuda(what, q, k, v, kv_mask, q_mask)
    B, H, Lq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    code = kernels.library().csn_flash_attn_fwd(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr(), q_mask.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Lq, k.shape[2], D, 1.0 / float(temperature),
        *drop, kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return out, lse


def flash_attention_bwd(q, k, v, dout, lse, delta, kv_mask=None, q_mask=None,
                        temperature: float = 1.0, dropout: float = 0.0,
                        seed: Optional[int] = None):
    """Launch the K2 backward: q, k, v and dout [B, H, L, D] of one dtype,
    lse and delta = rowsum(dout * out) [B, H, Lq] f32 -> (dq, dk, dv) in
    q's dtype. Same masks, temperature, dropout and seed as the forward."""
    what = "flash_attn_bwd"
    _check_qkv(what, q, k, v)
    drop = _drop_args(dropout, seed)
    kv_mask, q_mask = _masks(what, q, k, kv_mask, q_mask)
    B, H, Lq, D = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} {dout.dtype} "
                         f"does not match q")
    if lse.shape != (B, H, Lq) or delta.shape != (B, H, Lq) \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{what}: want f32 lse and delta [B, H, Lq]")
    kernels.require_cuda(what, q, k, v, dout, lse, delta, kv_mask, q_mask)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    code = kernels.library().csn_flash_attn_bwd(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        kv_mask.data_ptr(), q_mask.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, Lq, k.shape[2], D, 1.0 / float(temperature),
        *drop, kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K2 forward and its backward kernel as one differentiable op (the
    custom VJP of the JAX package's `flash_attention`). Saves `out` and
    `lse`; the masks, temperature, dropout and seed are not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_mask, temperature: float,
                dropout: float = 0.0, seed: Optional[int] = None):
        out, lse = flash_attention(q, k, v, kv_mask, q_mask, temperature,
                                   dropout, seed)
        ctx.save_for_backward(q, k, v, kv_mask, q_mask, out, lse)
        ctx.args = (temperature, dropout, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, q_mask, out, lse = ctx.saved_tensors
        temperature, dropout, seed = ctx.args
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, lse, delta, kv_mask,
                                         q_mask, temperature, dropout, seed)
        return dq, dk, dv, None, None, None, None, None
