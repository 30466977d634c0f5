// Flash attention forward over one key block with the online-softmax state
// carried in and out: the per-hop kernel of ring attention.
//
// Replaces: csn_tpu/ops/flash.py flash_forward_carry (Pallas body
// _fwd_carry_kernel), which the JAX package reaches through
// ops/attention.py ring_flash_attention from MultiHeadAttention when the
// point axis is sharded over a ring (the MID-FC full-attention branch).
//
// Computes K2's loop (flash_attn.cu) over the keys of this block, with the
// running max m [B, H, Lq], the denominator l [B, H, Lq] and the f32
// accumulator acc [B, H, Lq, D] read from the carry at the start and written
// back raw at the end: no division and no lse. The caller divides once after
// the last block (ops/flash.py flash_carry_finalize). A chain of calls over
// disjoint key blocks equals one K2 pass over their union; a block with no
// valid key leaves the carry untouched; the first carry is (-1e30, 0, 0).
// The dropout mask is keyed by absolute (query row, key column): row_off and
// col_off give this block's place in the global score matrix.
//
// What bounds it on the H100: as K2, 4*Lq*Lk*D flops per (batch, head)
// against (Lq + 2*Lk)*D reads plus the carry (2*Lq*(D + 2) f32 words in and
// out): compute-bound at the ring's shapes (Lq = Lk = 10000 / ranks,
// D = 256, 128 or 64).
//
// At D = 256 (the MID-FC heads, the ring's shape), D = 128 and D = 64 (the
// MID-FC heads at d_model 128 and 64; a ring at d_k below 64 comes
// zero-padded to 64) on the tensor cores, in the carry form of K2's body
// of each (dtype, D): f32 in split TF32 (three TF32 products per f32
// product), at 256 the body of flash_tf32_fwd.cuh, at 128 that of
// flash_tf32_d128_fwd.cuh, at 64 that of flash_tf32_d64_fwd.cuh; bf16 on
// mma.sync m16n8k16 with P rounded to bf16 once as the A operand of P V,
// at 256 the split body of flash_bf16_wide_fwd.cuh, at 128 and 64
// flash_tc_fwd.cuh's template. Their headers state the carry's units, the
// pass-through and the dropout words at any column offset. Each keeps the
// accumulator in the registers of the block that owns the query tile for
// the whole key loop, where the TPU kernel keeps it in VMEM scratch across
// its sequential kv grid axis, and touches the carry in device memory once
// on the way in and once on the way out.

#include "common.cuh"
#include "flash_bf16_wide_fwd.cuh"
#include "flash_tc_fwd.cuh"
#include "flash_tf32_d128_fwd.cuh"
#include "flash_tf32_d64_fwd.cuh"
#include "flash_tf32_fwd.cuh"

// q [B, H, Lq, D], k and v [B, H, Lk, D] contiguous in one type (q, k, v
// and acc_in 16-byte aligned); kv_mask [B, Lk], q_mask [B, Lq] bool bytes;
// m, l [B, H, Lq] and acc [B, H, Lq, D] f32, in and out (distinct buffers).
// D is 64, 128 or 256. Dropout arguments as csn_flash_attn_fwd's. Returns
// the first CUDA error of the one body its (dtype, D) selects.
extern "C" int csn_flash_attn_carry(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_mask, const void* q_mask, const void* m_in,
    const void* l_in, const void* acc_in, void* m_out, void* l_out,
    void* acc_out, int B, int H, int Lq, int Lk, int D, float inv_temp,
    uint64_t seed, uint32_t thresh, float inv_keep, int use_drop, int row_off,
    int col_off, void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csn::Carry cy{static_cast<const float*>(m_in),
                      static_cast<const float*>(l_in),
                      static_cast<const float*>(acc_in),
                      static_cast<float*>(m_out), static_cast<float*>(l_out),
                      static_cast<float*>(acc_out)};
  const csn::Drop drop{seed, thresh, inv_keep, use_drop, row_off, col_off};
  // the dropout words of drop_words / keep_bits need a key tile on a
  // multiple of 4 columns
  const bool any_col = use_drop && col_off % 4 != 0;
  if (dtype == csn::kF32 && D == 256)
    return any_col ? csn_tf32::launch_fwd_tf32<true, true>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s)
                   : csn_tf32::launch_fwd_tf32<true, false>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s);
  if (dtype == csn::kBF16 && D == 256)
    return any_col ? csn_tcw::launch_fwd_split<256, true, true>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s)
                   : csn_tcw::launch_fwd_split<256, true, false>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s);
  if (dtype == csn::kF32 && D == 128)
    return any_col ? csn_tf32_d128::launch_fwd<true, true>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s)
                   : csn_tf32_d128::launch_fwd<true, false>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s);
  if (dtype == csn::kBF16 && D == 128)
    return any_col ? csn_tc_fwd::launch_fwd<128, true, true>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s)
                   : csn_tc_fwd::launch_fwd<128, true, false>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s);
  if (dtype == csn::kF32 && D == 64)
    return any_col ? csn_tf32_d64::launch_fwd<true, true>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s)
                   : csn_tf32_d64::launch_fwd<true, false>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s);
  if (dtype == csn::kBF16 && D == 64)
    return any_col ? csn_tc_fwd::launch_fwd<64, true, true>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s)
                   : csn_tc_fwd::launch_fwd<64, true, false>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s);
  return cudaErrorInvalidValue;
}
