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
// D = 256).
//
// At D = 256 (the MID-FC heads, the ring's shape) on the tensor cores, in
// the carry form of K2's body of each dtype: f32 the split-TF32 body of
// flash_tf32_fwd.cuh (three TF32 products per f32 product), bf16 the split
// body of flash_bf16_wide_fwd.cuh (mma.sync m16n8k16, P rounded to bf16
// once as the A operand of P V); their headers state the carry's units,
// the pass-through and the dropout words at any column offset. Both keep
// the accumulator in the registers of the block that owns the query tile
// for the whole key loop, where the TPU kernel keeps it in VMEM scratch
// across its sequential kv grid axis, and touch the carry in device memory
// once on the way in and once on the way out. The other head dims, 64 and
// 128 in either dtype (a ring at d_k <= 128, zero-padded up to them), take
// the f32 CUDA-core kernel of flash_wide.cuh with CARRY set.

#include "common.cuh"
#include "flash_bf16_wide_fwd.cuh"
#include "flash_tf32_fwd.cuh"
#include "flash_wide.cuh"

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
  if (D == csn_tf32::D && (dtype == csn::kF32 || dtype == csn::kBF16)) {
    const csn_tf32::Carry cy{static_cast<const float*>(m_in),
                             static_cast<const float*>(l_in),
                             static_cast<const float*>(acc_in),
                             static_cast<float*>(m_out),
                             static_cast<float*>(l_out),
                             static_cast<float*>(acc_out)};
    const csn_tf32::Drop drop{seed, thresh, inv_keep, use_drop, row_off,
                              col_off};
    // the dropout words of drop_words need a key tile on a multiple of 4
    const bool any_col = use_drop && col_off % 4 != 0;
    if (dtype == csn::kBF16)
      return any_col ? csn_tcw::launch_fwd_split<256, true, true>(
                           q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B,
                           H, Lq, Lk, inv_temp, drop, s)
                     : csn_tcw::launch_fwd_split<256, true, false>(
                           q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B,
                           H, Lq, Lk, inv_temp, drop, s);
    return any_col ? csn_tf32::launch_fwd_tf32<true, true>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s)
                   : csn_tf32::launch_fwd_tf32<true, false>(
                         q, k, v, kv_mask, q_mask, nullptr, nullptr, cy, B, H,
                         Lq, Lk, inv_temp, drop, s);
  }
#define CSN_CARRY(T, DD)                                                     \
  return csn_wide::launch_fwd_wide<T, DD, true>(                             \
      q, k, v, kv_mask, q_mask, nullptr, nullptr, m_in, l_in, acc_in, m_out, \
      l_out, acc_out, B, H, Lq, Lk, inv_temp, seed, thresh, inv_keep,        \
      use_drop, row_off, col_off, s)
  if (dtype == csn::kF32) {
    if (D == 64) CSN_CARRY(float, 64);
    if (D == 128) CSN_CARRY(float, 128);
  }
  if (dtype == csn::kBF16) {
    if (D == 64) CSN_CARRY(__nv_bfloat16, 64);
    if (D == 128) CSN_CARRY(__nv_bfloat16, 128);
  }
#undef CSN_CARRY
  return cudaErrorInvalidValue;
}
