"""Kernel K2: masked flash attention forward on the H100.

Counterpart of `csn_tpu/ops/flash.py`, whose `_flash_forward` ran the
online-softmax attention as a Pallas TPU kernel over a sequential kv grid
axis with VMEM scratch. The CUDA kernel (`csn_tpu_torch/csrc/flash_attn.cu`)
runs one block per (batch*head, 64-query tile) and loops over 64-key tiles
inside the block, skipping query tiles with no valid query and key tiles
with no valid key. It returns `out` and the f32 log-sum-exp rows `lse`,
which the backward kernel will read. Its plain version is
`csn_tpu_torch.ops.attention.scaled_dot_product_attention`.

Attention-weight dropout is not in the kernel yet: the eval path runs
without it, and a nonzero rate raises until the training kernels add it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from csn_tpu_torch import kernels

NEG_INF = -1e30
HEAD_DIM = 64  # d_model 256 / 4 heads, the HRNet CSN heads


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    q_mask: Optional[torch.Tensor] = None,
                    temperature: float = 1.0, dropout: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2: q [B, H, Lq, D], k and v [B, H, Lk, D], kv_mask [B, Lk]
    and q_mask [B, Lq] bool -> (out [B, H, Lq, D] in q's dtype, lse
    [B, H, Lq] f32). Rows whose q_mask is false are padding: junk by
    contract (zeros where a whole 64-row tile is padding)."""
    what = "flash_attn_fwd"
    if dropout != 0.0:
        raise NotImplementedError(
            f"{what}: attention dropout is not implemented in the kernel yet")
    if q.dim() != 4 or k.shape[:2] != q.shape[:2] or v.shape != k.shape \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: want q [B, H, Lq, D], k and v [B, H, Lk, "
                         f"D]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if D != HEAD_DIM:
        raise ValueError(f"{what}: head dim {D} != {HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: q, k, v dtypes differ")
    if kv_mask is None:
        kv_mask = torch.ones((B, Lk), dtype=torch.bool, device=q.device)
    if q_mask is None:
        q_mask = torch.ones((B, Lq), dtype=torch.bool, device=q.device)
    if kv_mask.shape != (B, Lk) or q_mask.shape != (B, Lq):
        raise ValueError(f"{what}: masks {tuple(kv_mask.shape)}, "
                         f"{tuple(q_mask.shape)} do not fit B={B}, Lq={Lq}, "
                         f"Lk={Lk}")
    kv_mask = kv_mask.to(torch.bool).contiguous()
    q_mask = q_mask.to(torch.bool).contiguous()
    kernels.require_cuda(what, q, k, v, kv_mask, q_mask)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    code = kernels.library().csn_flash_attn_fwd(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr(), q_mask.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Lq, Lk, D, 1.0 / float(temperature),
        kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return out, lse
