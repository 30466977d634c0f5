"""Kernel K2, its backward, and their per-key-block forms for ring
attention: masked flash attention on the H100, with in-kernel attention
dropout.

Counterpart of `csn_tpu/ops/flash.py`, whose `_flash_forward`,
`flash_forward_carry` and `_flash_backward` ran the online-softmax attention
and its gradient as Pallas TPU kernels over sequential grid axes with VMEM
scratch.

* Forward (`csn_tpu_torch/csrc/flash_attn.cu`): one block per (batch*head,
  64-query tile) loops over the key tiles, skipping query tiles with no
  valid query and key tiles with no valid key. Returns `out` and the f32
  log-sum-exp rows `lse`.
* Backward (`csn_tpu_torch/csrc/flash_attn_bwd.cu`): dQ, dK, dV from q, k,
  v, dO, `lse` and `delta = rowsum(dO * O)` (plain torch, as the JAX package
  computes it in XLA), in two deterministic passes (dK/dV per key tile, dQ
  per query tile) that skip the forward's tiles.
* Head dims 1 to 256. The kernels are built at the widths of `K2_HEAD_DIMS`
  (K2 and its backward: bf16 16, 32, 64, 128, 256; f32 64, 128, 256) and
  `RING_HEAD_DIMS` (the carry and the block backward: 64, 128, 256 in both
  dtypes); a head dim between them is zero-padded along D to the next
  width (`pad_head`) and the outputs are cut back. The result is exact: a
  zero column adds +0 to every score, a zero column of v gives an output
  column of zeros, delta = rowsum(dO * O) is unchanged, and the padded
  columns of dQ, dK and dV are cut off. The temperature is the caller's
  (sqrt of the true d_k), and the dropout mask, keyed by (seed,
  batch*head, row, column), does not depend on D. Above 256 the wrappers
  refuse: no body is built wider than the MID-FC heads. bf16 runs K2 and
  its backward on the tensor cores at every width (`mma.sync` with f32
  accumulators, `cp.async` and `ldmatrix` tiles): at D = 16, 32 and 64 (64:
  the HRNet heads) both directions in one template over D each
  (`csrc/flash_tc_fwd.cuh`, `csrc/flash_tc_bwd.cuh`, over the blocks of
  `csrc/flash_tc.cuh`), and so the forward at D = 128; the forward at
  D = 256 and the backward at 128 and 256 (d_model 256 in 2 heads or 1, the
  MID-FC heads in bf16) in a layout of 8 warps that split D among them
  (`csrc/flash_bf16_wide_fwd.cuh`, `csrc/flash_bf16_wide_bwd.cuh`; the
  backward hands dS^T to its dQ pass through a bf16 scratch,
  `_ds_scratch`), whose launches count apart under `"_bf16_wide"`. f32 at
  D = 256 (the MID-FC heads, d_k = d_v = 256 per head) runs the forward,
  the backward and the block backward on them in split TF32, three TF32
  products per f32 product (`csrc/flash_tf32_fwd.cuh`,
  `csrc/flash_tf32_bwd.cuh` over the blocks of `csrc/flash_tf32.cuh`), and
  so do f32 K2 and its backward at D = 128 (the HRNet heads with f32
  activations at d_model 256 in 2 heads; `csrc/flash_tf32_d128_fwd.cuh`
  and the passes of `csrc/flash_tf32_bwd.cuh` at half the width, handing
  dS^T to the dQ pass through an f32 scratch; launches counted apart under
  `"_tf32_d128"`) and at D = 64 (in 4 heads; `csrc/flash_tf32_d64_fwd.cuh`,
  `csrc/flash_tf32_d64_bwd.cuh`, under `"_tf32_d64"`). No attention body
  runs on the CUDA cores.
* Carry forward (`csrc/flash_attn_carry.cu`, `flash_forward_carry`): K2's
  loop over ONE key block with the running max, denominator and f32
  accumulator carried in and written back raw; `flash_carry_finalize`
  divides once. A chain over disjoint key blocks equals one K2 pass over
  their union. At D = 256 (the ring's shape, the MID-FC heads), 128 and 64
  (the MID-FC heads at d_model 128 and 64) it runs the carry form of K2's
  tensor-core body of its (dtype, D): f32 in split TF32
  (`csrc/flash_tf32_fwd.cuh`; at 128 `csrc/flash_tf32_d128_fwd.cuh` and at
  64 `csrc/flash_tf32_d64_fwd.cuh`, launches counted apart under
  `"_tf32_d128"` and `"_tf32_d64"`), bf16 the split body at 256
  (`csrc/flash_bf16_wide_fwd.cuh`) and the template of
  `csrc/flash_tc_fwd.cuh` at 128 and 64, counted under `"_bf16_wide"` and
  `"_bf16_d64"` (`ring_row`). Its plain version is
  `ops.attention.online_block_update`.
* Block backward (`csrc/flash_attn_block_bwd.cu`, `flash_block_backward`):
  the two backward passes on one key block given the GLOBAL `lse`, `delta`
  and `dout`; returns that block's dK, dV and its f32 term of dQ. At D = 256
  and 128 the passes of K2's backward body of its (dtype, D) with an f32
  dQ term (f32 `csrc/flash_tf32_bwd.cuh`, at 128 counted apart under
  `"_tf32_d128"`; bf16 `csrc/flash_bf16_wide_bwd.cuh`, counted apart under
  `"_bf16_wide"`), each handing dS^T through a scratch
  (`DS_SCRATCH["block"]`); at 64 those of K2's D = 64 bodies, which
  recompute dS in their dQ pass (f32 `csrc/flash_tf32_d64_bwd.cuh` under
  `"_tf32_d64"`, bf16 `csrc/flash_tc_bwd.cuh` under `"_bf16_d64"`). Its
  plain version is `block_backward_plain`.
* Dropout: the mask is a function of (seed, batch*head, query row, key
  column) only, through the counter-based generator Philox4x32-10, written
  twice bit for bit: `philox4x32` here (torch int64 ops, the plain
  version's mask) and `csn::philox4x32` in `csrc/common.cuh`. Key column c
  of row r is kept when word c % 4 of Philox((c // 4, r, bh, 0), seed) is
  below floor(keep * 2^32). Forward, backward and the plain version drop
  the same entries whatever their tiling: the TPU kernel's `_drop_mask`
  records that a block-shaped mask with different forward and backward
  blocks gave a biased gradient that sent training to NaN. The per-block
  forms take the block's row and column offsets in the global score matrix,
  so a ring at any world size drops exactly the single-device mask's entries.

The plain version is `csn_tpu_torch.ops.attention.scaled_dot_product_attention`
(its backward is autograd's). `FlashAttentionFn` is the autograd Function
over the two kernels; it takes CUDA tensors only. The per-block wrappers
take their plain versions for CPU tensors and launch their kernels for CUDA
tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from csn_tpu_torch import kernels

NEG_INF = -1e30
# the head dims the kernels are built for, by dtype; any other head dim up
# to MAX_HEAD_DIM is zero-padded to the next (64: d_model 256 / 4 heads, the
# HRNet CSN heads; 256: the MID-FC heads; 32 and 16 on the tensor cores in
# bf16: d_model 64 or 32 in 2 heads, 256 in 8 or 16)
K2_HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 128, 256),
                torch.float32: (64, 128, 256)}
RING_HEAD_DIMS = (64, 128, 256)   # the carry and the block backward
MAX_HEAD_DIM = 256
# The backward bodies that pass dS from their dK/dV pass to their dQ pass
# through a scratch of B * H * ceil32(Lk) * ceil32(Lq) elements in q's
# dtype, by form ("k2": K2's backward, "block": the ring's block backward)
# and dtype: f32 at 128 and 256 in both forms (csrc/flash_tf32_bwd.cuh;
# 4.1 GB at the HRNet SSA call in 2 heads of 128 [16, 2, 5632, 128], 6.4 GB
# at the ring of one [2, 8, 10000, 128 or 256]), bf16 at 128 and 256 in both
# forms (csrc/flash_bf16_wide_bwd.cuh; 3.2 GB at the ring of one). The f32
# D = 64 bodies of both dtypes, K2's backward and the ring's block form,
# recompute dS in their dQ pass instead (the f32 scratch would be 8.1 GB at
# the HRNet SSA call in 4 heads of 64).
DS_SCRATCH = {"k2": {torch.float32: (128, 256),
                     torch.bfloat16: (128, 256)},
              "block": {torch.float32: (128, 256),
                        torch.bfloat16: (128, 256)}}


def _ceil32(n: int) -> int:
    return -(-n // 32) * 32


def _ds_scratch(q, B, H, Lq, Lk, D, form: str = "k2"
                ) -> Optional[torch.Tensor]:
    """The scratch through which the backward body of `form` at (q's dtype,
    D) hands dS^T from its dK/dV pass to its dQ pass (`DS_SCRATCH`), in q's
    dtype; None for the other bodies, which read none."""
    if D not in DS_SCRATCH[form].get(q.dtype, ()):
        return None
    return torch.empty(B * H * _ceil32(Lk) * _ceil32(Lq), dtype=q.dtype,
                       device=q.device)


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
                      device=None, batch_offset: int = 0,
                      row_offset: int = 0, col_offset: int = 0
                      ) -> torch.Tensor:
    """The attention-dropout keep mask [b, H, Lq, Lk] (bool) of batch rows
    batch_offset .. batch_offset + b - 1, query rows row_offset .. and key
    columns col_offset .. of the global score matrix: entry (b, h, r, c)
    (absolute r, c) is kept when word c % 4 of Philox((c // 4, r, b * H + h,
    0), (seed lo, seed hi)) is below `keep_threshold(dropout)`."""
    b, h, lq, lk = shape
    g0 = col_offset // 4                      # first Philox group touched
    n4 = -(-(col_offset + lk) // 4) - g0
    i64 = dict(dtype=torch.int64, device=device)
    bh = ((torch.arange(b, **i64) + batch_offset)[:, None] * h
          + torch.arange(h, **i64))[:, :, None, None]
    rows = (torch.arange(lq, **i64) + row_offset)[:, None]
    col4 = torch.arange(n4, **i64) + g0
    words = philox4x32((col4, rows, bh, torch.zeros((), **i64)),
                       (seed & _MASK32, (seed >> 32) & _MASK32))
    lo = col_offset - 4 * g0
    bits = torch.stack(words, dim=-1).reshape(b, h, lq, 4 * n4)[
        ..., lo:lo + lk]
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


def _check_qkv(what, q, k, v, kernel: bool = True):
    """Shapes and dtypes of q, k, v; with `kernel`, also that the head dim
    is one the kernels take, 1 to MAX_HEAD_DIM (the plain versions take
    any)."""
    if q.dim() != 4 or k.shape[:2] != q.shape[:2] or v.shape != k.shape \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: want q [B, H, Lq, D], k and v [B, H, Lk, "
                         f"D]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if kernel and not 1 <= q.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(
            f"{what}: head dim {q.shape[3]} outside 1..{MAX_HEAD_DIM}: no "
            f"kernel body is built wider than the MID-FC heads' "
            f"{MAX_HEAD_DIM} (split q, k, v into more heads)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: q, k, v dtypes differ")


def padded_head_dim(d: int, widths: Sequence[int]) -> int:
    """The narrowest of `widths` that holds head dim `d` (`d` itself when
    none does: the kernels' checks refuse it)."""
    return next((w for w in widths if w >= d), d)


def k2_head_dim(q: torch.Tensor) -> int:
    """The head dim K2 and its backward run q's head dim at, in q's dtype."""
    return padded_head_dim(q.shape[-1], K2_HEAD_DIMS.get(q.dtype,
                                                         RING_HEAD_DIMS))


def k2_split_tf32_d64(dtype: torch.dtype, d: int) -> bool:
    """Whether K2 and its backward run head dim `d` in `dtype` on the f32
    D=64 split-TF32 bodies (`csrc/flash_tf32_d64_*.cuh`; f32 head dims
    below 64 run there zero-padded), whose launches count apart under
    `"_tf32_d64"`."""
    return dtype == torch.float32 and padded_head_dim(
        d, K2_HEAD_DIMS[dtype]) == 64


def k2_split_tf32_d128(dtype: torch.dtype, d: int) -> bool:
    """Whether K2 and its backward run head dim `d` in `dtype` on the f32
    D=128 split-TF32 bodies (`csrc/flash_tf32_d128_fwd.cuh`, and
    `csrc/flash_tf32_bwd.cuh` at head dim 128; f32 head dims 65-127 run
    there zero-padded), whose launches count apart under `"_tf32_d128"`."""
    return dtype == torch.float32 and padded_head_dim(
        d, K2_HEAD_DIMS[dtype]) == 128


def k2_bf16_wide(dtype: torch.dtype, d: int) -> bool:
    """Whether K2 and its backward run head dim `d` in `dtype` at the bf16
    widths 128 and 256 (bf16 head dims 65-256, zero-padded up to those
    widths), whose launches count apart under `"_bf16_wide"`: the forward
    at 128 on `csrc/flash_tc.cuh`'s template, the forward at 256 and the
    backward at both on `csrc/flash_bf16_wide_*.cuh`."""
    return dtype == torch.bfloat16 and padded_head_dim(
        d, K2_HEAD_DIMS[dtype]) in (128, 256)


def k2_row(what: str, dtype: torch.dtype, d: int) -> str:
    """The `kernels.LAUNCHES` row of a K2 launch (`what`: "flash_attn_fwd"
    or "flash_attn_bwd") at head dim `d` in `dtype`: `what + "_tf32_d64"`
    and `what + "_tf32_d128"` on the f32 D=64 and D=128 bodies,
    `what + "_bf16_wide"` at the bf16 widths 128 and 256, else `what`."""
    if k2_split_tf32_d64(dtype, d):
        return what + "_tf32_d64"
    if k2_split_tf32_d128(dtype, d):
        return what + "_tf32_d128"
    return what + "_bf16_wide" if k2_bf16_wide(dtype, d) else what


def ring_row(what: str, dtype: torch.dtype, d: int) -> str:
    """The `kernels.LAUNCHES` row of a launch of the ring's per-block
    kernels (`what`: "flash_attn_carry" or "flash_attn_block_bwd") at head
    dim `d` in `dtype`, as `k2_row` names K2's: `what + "_tf32_d64"` and
    `what + "_tf32_d128"` where f32 runs at the widths 64 and 128 (f32 head
    dims 1-64 on the split-TF32 bodies of `csrc/flash_tf32_d64_*.cuh`,
    65-128 on those of `csrc/flash_tf32_d128_fwd.cuh` and
    `csrc/flash_tf32_bwd.cuh`), `what + "_bf16_d64"` where bf16 runs at the
    width 64 (bf16 head dims 1-64, on `csrc/flash_tc_fwd.cuh` and
    `csrc/flash_tc_bwd.cuh`), `what + "_bf16_wide"` at the widths 128 and
    256 (bf16 head dims 65-256, on `csrc/flash_tc_fwd.cuh` and
    `csrc/flash_bf16_wide_*.cuh`), else `what` (f32 at 256)."""
    width = padded_head_dim(d, RING_HEAD_DIMS)
    if dtype == torch.float32:
        return what + {64: "_tf32_d64", 128: "_tf32_d128"}.get(width, "")
    return what + ("_bf16_d64" if width == 64 else "_bf16_wide")


def pad_head(x: torch.Tensor, width: int) -> torch.Tensor:
    """x [..., D] zero-padded along its last dim to `width` (x itself when
    D == width). Exact for attention at the caller's temperature: the zero
    columns add +0 to every score of q . k and give zero output columns
    from v, which the caller cuts off."""
    d = x.shape[-1]
    return x if d == width else F.pad(x, (0, width - d))


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


def _require_aligned(what, *tensors):
    """The tensor-core bodies (K2's, its backward's and the ring's, at every
    dtype and head dim) copy their tiles 16 bytes at a time with cp.async,
    and the carry kernels read the accumulator in 8- and 16-byte words: a
    misaligned start would read the wrong bytes rather than fail. A
    zero-padded head is a fresh allocation, aligned."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: q, k, v (and dout, or the carry's acc) "
                         f"must start on a 16-byte boundary: the tensor-core "
                         f"bodies copy them 16 bytes at a time")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    q_mask: Optional[torch.Tensor] = None,
                    temperature: float = 1.0, dropout: float = 0.0,
                    seed: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2: q [B, H, Lq, D], k and v [B, H, Lk, D] (D in 1..256; a D
    the kernel is not built for runs zero-padded to the next,
    `k2_head_dim`), kv_mask [B, Lk] and q_mask [B, Lq] bool -> (out
    [B, H, Lq, D] in q's dtype, lse [B, H, Lq] f32). Rows whose q_mask is
    false are padding: junk by contract (zeros where a whole 64-row tile
    is padding). With dropout > 0
    the probabilities of the numerator are dropped by the mask of `seed`
    (`dropout_keep_mask`); `lse` stays undropped."""
    what = "flash_attn_fwd"
    _check_qkv(what, q, k, v)
    drop = _drop_args(dropout, seed)
    kv_mask, q_mask = _masks(what, q, k, kv_mask, q_mask)
    kernels.require_cuda(what, q, k, v, kv_mask, q_mask)
    d, width = q.shape[3], k2_head_dim(q)
    if width != d:   # the next body up, on zero-padded heads
        out, lse = flash_attention(
            *(pad_head(x, width) for x in (q, k, v)), kv_mask, q_mask,
            temperature, dropout, seed)
        return out[..., :d].contiguous(), lse
    _require_aligned(what, q, k, v)
    B, H, Lq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    code = kernels.library().csn_flash_attn_fwd(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr(), q_mask.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Lq, k.shape[2], D, 1.0 / float(temperature),
        *drop, kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[k2_row(what, q.dtype, D)] += 1
    return out, lse


def flash_attention_bwd(q, k, v, dout, lse, delta, kv_mask=None, q_mask=None,
                        temperature: float = 1.0, dropout: float = 0.0,
                        seed: Optional[int] = None):
    """Launch the K2 backward: q, k, v and dout [B, H, L, D] of one dtype,
    lse and delta = rowsum(dout * out) [B, H, Lq] f32 -> (dq, dk, dv) in
    q's dtype. Same masks, temperature, dropout and seed as the forward;
    a head dim the kernel is not built for runs zero-padded, as there."""
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
    width = k2_head_dim(q)
    if width != D:   # the next body up, on zero-padded heads
        grads = flash_attention_bwd(
            *(pad_head(x, width) for x in (q, k, v, dout)), lse, delta,
            kv_mask, q_mask, temperature, dropout, seed)
        return tuple(x[..., :D].contiguous() for x in grads)
    _require_aligned(what, q, k, v, dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    Lk = k.shape[2]
    ds_t = _ds_scratch(q, B, H, Lq, Lk, D)
    code = kernels.library().csn_flash_attn_bwd(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        kv_mask.data_ptr(), q_mask.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), 0 if ds_t is None else ds_t.data_ptr(), B, H, Lq, Lk,
        D, 1.0 / float(temperature), *drop, kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[k2_row(what, q.dtype, D)] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K2 forward and its backward kernel as one differentiable op (the
    custom VJP of the JAX package's `flash_attention`). A head dim the
    kernels are not built for is zero-padded once here (`k2_head_dim`):
    the padded q, k, v and `out` are saved with `lse`, the backward pads
    dout and cuts dq, dk, dv back. The masks, temperature, dropout and seed
    are not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_mask, temperature: float,
                dropout: float = 0.0, seed: Optional[int] = None):
        _check_qkv("flash_attn_fwd", q, k, v)
        d, width = q.shape[3], k2_head_dim(q)
        q, k, v = (pad_head(x, width) for x in (q, k, v))
        out, lse = flash_attention(q, k, v, kv_mask, q_mask, temperature,
                                   dropout, seed)
        ctx.save_for_backward(q, k, v, kv_mask, q_mask, out, lse)
        ctx.args = (d, temperature, dropout, seed)
        return out[..., :d].contiguous() if width != d else out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, q_mask, out, lse = ctx.saved_tensors
        d, temperature, dropout, seed = ctx.args
        dout = pad_head(dout.contiguous(), q.shape[3])
        delta = (dout.float() * out.float()).sum(dim=-1)
        grads = flash_attention_bwd(q, k, v, dout, lse, delta, kv_mask,
                                    q_mask, temperature, dropout, seed)
        dq, dk, dv = (x[..., :d] if q.shape[3] != d else x for x in grads)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------------------
# per-key-block forms (ring attention)
# ---------------------------------------------------------------------------

def flash_carry_init(b: int, h: int, lq: int, dv: int, device=None):
    """Fresh (m, l, acc) carry of `flash_forward_carry`: the (NEG_INF, 0, 0)
    state K2 starts from."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.full((b, h, lq), NEG_INF, **f32),
            torch.zeros((b, h, lq), **f32),
            torch.zeros((b, h, lq, dv), **f32))


def flash_carry_finalize(carry):
    """(m, l, acc) -> (out [B, H, Lq, Dv] f32, lse [B, H, Lq]), with K2's
    finalize (denominator floored at 1e-30). Plain torch."""
    m, l, acc = carry
    den = l.clamp(min=1e-30)
    return acc / den[..., None], m + torch.log(den)


def _check_carry(what, q, carry):
    B, H, Lq, D = q.shape
    m, l, acc = carry
    if m.shape != (B, H, Lq) or l.shape != (B, H, Lq) \
            or acc.shape != (B, H, Lq, D) \
            or not (m.dtype == l.dtype == acc.dtype == torch.float32):
        raise ValueError(f"{what}: want an f32 carry (m, l [B, H, Lq], acc "
                         f"[B, H, Lq, D]); got {tuple(m.shape)}, "
                         f"{tuple(l.shape)}, {tuple(acc.shape)}")


def flash_forward_carry(q, k, v, kv_mask, q_mask, carry, temperature: float,
                        dropout: float = 0.0, seed: Optional[int] = None,
                        row_offset: int = 0, col_offset: int = 0):
    """One flash pass over THIS key block, continuing the online-softmax
    state `carry` = (m [B, H, Lq], l [B, H, Lq], acc [B, H, Lq, D]), all f32.
    Returns the updated carry, un-normalised (`flash_carry_finalize`); rows
    whose q_mask is false keep the carry as it came in (the kernels also
    copy it through for a block with no valid key). `row_offset` /
    `col_offset` place q's rows and this block's columns in the global
    score matrix for the dropout mask. CUDA tensors launch the
    carry kernel (a head dim outside `RING_HEAD_DIMS` zero-padded to the
    next, acc too, and cut back); CPU tensors take
    `ops.attention.online_block_update`. Not differentiable on its own:
    `RingFlashAttentionFn` wraps the whole ring."""
    what = "flash_attn_carry"
    _check_qkv(what, q, k, v, kernel=q.is_cuda)
    _check_carry(what, q, carry)
    drop = _drop_args(dropout, seed)
    kv_mask, q_mask = _masks(what, q, k, kv_mask, q_mask)
    if q.device.type == "cpu":
        from csn_tpu_torch.ops.attention import online_block_update

        new = online_block_update(
            carry, (q / temperature).float(), k, v, kv_mask, dropout=dropout,
            seed=seed, row_offset=row_offset, col_offset=col_offset)
        # padding rows pass the carry through, as in the kernel
        live = q_mask[:, None, :]
        return (torch.where(live, new[0], carry[0]),
                torch.where(live, new[1], carry[1]),
                torch.where(live[..., None], new[2], carry[2]))
    carry = tuple(c.contiguous() for c in carry)
    kernels.require_cuda(what, q, k, v, kv_mask, q_mask, *carry)
    B, H, Lq, D = q.shape
    width = padded_head_dim(D, RING_HEAD_DIMS)
    if width != D:   # the next body up, on zero-padded heads
        m, l, acc = flash_forward_carry(
            *(pad_head(x, width) for x in (q, k, v)), kv_mask, q_mask,
            carry[:2] + (pad_head(carry[2], width),), temperature, dropout,
            seed, row_offset, col_offset)
        return m, l, acc[..., :D].contiguous()
    _require_aligned(what, q, k, v, carry[2])
    out = tuple(torch.empty_like(c) for c in carry)
    code = kernels.library().csn_flash_attn_carry(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr(), q_mask.data_ptr(), *(c.data_ptr() for c in carry),
        *(c.data_ptr() for c in out), B, H, Lq, k.shape[2], D,
        1.0 / float(temperature), *drop, int(row_offset), int(col_offset),
        kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[ring_row(what, q.dtype, D)] += 1
    return out


def block_backward_plain(q, k, v, kv_mask, lse, delta, g, temperature: float,
                         dropout: float = 0.0, seed: Optional[int] = None,
                         row_offset: int = 0, col_offset: int = 0,
                         compute_dtype: torch.dtype = torch.float32):
    """Plain version of the block backward: with s = (q / T) . k masked to
    NEG_INF, p = exp(s - lse) against the GLOBAL lse, the dropout mask m:
    dPd = m * (g . v^T) / keep, dS = p * (dPd - delta), dV = (m * p / keep)^T
    . g, dK = dS^T . (q / T), dQ = dS . k / T, all in `compute_dtype` (f32;
    float64 gives a reference for both f32 versions). Returns (dq in
    `compute_dtype`, dk, dv in k's dtype)."""
    ct = compute_dtype
    qt = (q / temperature).to(ct)
    kf, vf, gf = k.to(ct), v.to(ct), g.to(ct)
    s = torch.matmul(qt, kf.transpose(-1, -2))
    s = s.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    p = torch.exp(s - lse.to(ct)[..., None])
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    pn = p
    if dropout > 0.0:
        keep = dropout_keep_mask(seed, dropout, tuple(p.shape), p.device,
                                 row_offset=row_offset, col_offset=col_offset)
        scale = 1.0 / (1.0 - dropout)
        zero = torch.zeros((), dtype=ct, device=p.device)
        dp = torch.where(keep, dp * scale, zero)
        pn = torch.where(keep, p * scale, zero)
    ds = p * (dp - delta.to(ct)[..., None])
    dv = torch.matmul(pn.transpose(-1, -2), gf)
    dk = torch.matmul(ds.transpose(-1, -2), qt)
    dq = torch.matmul(ds, kf) / temperature
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_block_backward(q, k, v, kv_mask, out, lse, g, temperature: float,
                         dropout: float = 0.0, seed: Optional[int] = None,
                         row_offset: int = 0, col_offset: int = 0,
                         delta: Optional[torch.Tensor] = None):
    """Backward for one key block of a ring: given the GLOBAL (out, lse, g)
    and one key block, returns (dq term in f32, dk, dv of the block in k's
    dtype). Summing dq over the blocks and keeping dk, dv per block is the
    full flash backward split across the ring. `delta` = rowsum(g * out), if
    the caller already has it (it is the same for every block). CUDA tensors
    launch the block-backward kernel (a head dim outside `RING_HEAD_DIMS`
    zero-padded to the next and cut back; delta is unchanged); CPU tensors
    take `block_backward_plain`."""
    what = "flash_attn_block_bwd"
    _check_qkv(what, q, k, v, kernel=q.is_cuda)
    drop = _drop_args(dropout, seed)
    kv_mask, q_mask = _masks(what, q, k, kv_mask, None)  # every row valid
    B, H, Lq, D = q.shape
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"{what}: g {tuple(g.shape)} {g.dtype} does not "
                         f"match q")
    if delta is None:
        delta = (g.float() * out.float()).sum(dim=-1)
    if lse.shape != (B, H, Lq) or delta.shape != (B, H, Lq) \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{what}: want f32 lse and delta [B, H, Lq]")
    if q.device.type == "cpu":
        return block_backward_plain(
            q, k, v, kv_mask, lse, delta, g, temperature, dropout, seed,
            row_offset, col_offset)
    g = g.contiguous()
    kernels.require_cuda(what, q, k, v, g, lse, delta, kv_mask, q_mask)
    width = padded_head_dim(D, RING_HEAD_DIMS)
    if width != D:   # the next body up, on zero-padded heads
        grads = flash_block_backward(
            *(pad_head(x, width) for x in (q, k, v)), kv_mask, None, lse,
            pad_head(g, width), temperature, dropout, seed, row_offset,
            col_offset, delta)
        return tuple(x[..., :D].contiguous() for x in grads)
    _require_aligned(what, q, k, v, g)
    Lk = k.shape[2]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ds_t = _ds_scratch(q, B, H, Lq, Lk, D, "block")
    code = kernels.library().csn_flash_attn_block_bwd(
        kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), kv_mask.data_ptr(),
        q_mask.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        0 if ds_t is None else ds_t.data_ptr(), B, H, Lq, Lk, D,
        1.0 / float(temperature), *drop, int(row_offset), int(col_offset),
        kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[ring_row(what, q.dtype, D)] += 1
    return dq, dk, dv
