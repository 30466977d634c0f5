// Masked flash attention forward (online softmax), with the log-sum-exp rows.
//
// Replaces: csn_tpu/ops/flash.py _flash_forward (Pallas body _fwd_kernel),
// which the JAX package reaches through flash_attention from
// ops/attention.py MultiHeadAttention.
//
// Computes, per (batch*head, query row) with valid keys j (kv_mask true):
//   s_j = (q / temperature) . k_j,  out = sum_j softmax(s)_j v_j,
//   lse = max_j s_j + log(sum_j exp(s_j - max)),
// with masked keys at NEG_INF = -1e30, the denominator floored at 1e-30,
// out stored in the activation type and lse in f32. A query tile with no
// valid query is skipped and written as zeros (its rows are padding, which
// callers mask), and so is a key tile with no valid key (it would add
// nothing). Only rows whose q_mask is true are part of the contract, as in
// the TPU kernel.
//
// Attention-weight dropout (rate 1 - keep, torch's dropout(softmax(s)) @ v)
// follows the TPU kernel's flash identity (flash.py:144-150): the numerator
// takes m_ij * p_ij / keep, the denominator and lse stay undropped. The mask
// m_ij comes from csn::dropout_bits, keyed by (seed, batch*head, query row,
// key column), so the backward kernels (flash_attn_bwd.cu) and the plain
// version regenerate exactly the same entries.
//
// What bounds it on the H100: 4*Lq*Lk*D flops against (Lq + 2*Lk)*D reads
// per (batch, head): at Lq = Lk = 5632 and D = 64 it is compute-bound.
// At a fixed d_model, heads of D = 32 or 16 do the same products over 2x
// or 4x the score entries, and the per-entry work (exp2, the running max,
// the Philox mask) rather than the tensor cores sets their time.
//
// bf16, D = TD in {16, 32, 64, 128} (64: the HRNet heads, d_model 256 in
// 4 heads; 128: d_model 256 in 2; 32: d_model 64 in 2 heads, as the
// learning check runs it, or 256 in 8; 16: d_model 32 in 2): both products
// on the tensor cores, the FlashAttention-2 shape, one template over TD
// (flash_tc_fwd.cuh, over flash_tc.cuh's blocks: TD / 16 k-steps of S,
// TD / 8 n-tiles of O; its header states the design, and it holds the
// ring's carry form too). One block of 4 warps per (batch*head, 64-query
// tile); each warp owns 16 query rows; Q's A fragments kept in registers;
// K and V tiles double-buffered by cp.async; P rounded to bf16 only as the
// A operand of O += P V. Dropout: lanes t and t^1 share one Philox group
// (flash_tc.cuh drop_words): one Philox call per 4 entries, as the mask
// has. The next step for this kernel is wgmma with TMA (ROADMAP B2).
//
// f32 at D = 256 (the MID-FC heads), at D = 128 (the HRNet heads with f32
// activations at d_model 256 in 2 heads) and at D = 64 (in 4 heads): the
// tensor cores in split TF32, three TF32 products per f32 product
// (flash_tf32_fwd.cuh, flash_tf32_d128_fwd.cuh, flash_tf32_d64_fwd.cuh):
// one TF32 product would miss the f32 checks' 1e-4, three hold it.
//
// bf16 at D = 256 (the MID-FC heads in bf16, d_model 256 in one head): the
// tensor cores in the layout of flash_tf32_fwd.cuh, 8 warps that split D
// in quarters (flash_bf16_wide_fwd.cuh), since 16 rows x 256 dims of O
// would take 128 registers a lane.
//
// Any other head dim up to 256 reaches this file zero-padded by its wrapper
// (ops/flash.py) to the next width built here for its dtype: a zero column
// adds an exact +0 to every score and gives an output column of zeros,
// which the wrapper cuts off.

#include "common.cuh"
#include "flash_bf16_wide_fwd.cuh"
#include "flash_tc_fwd.cuh"
#include "flash_tf32_d128_fwd.cuh"
#include "flash_tf32_d64_fwd.cuh"
#include "flash_tf32_fwd.cuh"

// q, k, v, out: [B, H, L, D] contiguous, 16-byte aligned; kv_mask [B, Lk],
// q_mask [B, Lq] bool bytes; lse [B, H, Lq] f32. D (dk == dv) is 16, 32,
// 64, 128 or 256 in bf16 (64: the HRNet heads; 256: the MID-FC heads), 64
// or 128 in f32 (the HRNet heads with f32 activations, in 4 heads or 2),
// or 256 in f32 (the MID-FC heads).
// use_drop != 0 applies dropout with keep threshold `thresh` (of 2^32) and
// scale inv_keep = 1/keep, keyed by `seed`.
extern "C" int csn_flash_attn_fwd(int dtype, const void* q, const void* k,
                                  const void* v, const void* kv_mask,
                                  const void* q_mask, void* out, void* lse,
                                  int B, int H, int Lq, int Lk, int D,
                                  float inv_temp, uint64_t seed,
                                  uint32_t thresh, float inv_keep,
                                  int use_drop, void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csn::Drop drop{seed, thresh, inv_keep, use_drop, 0, 0};
#define CSN_TC(DD)                                                         \
  return csn_tc_fwd::launch_fwd<DD>(q, k, v, kv_mask, q_mask, out, lse,    \
                                    csn::Carry{}, B, H, Lq, Lk, inv_temp,  \
                                    drop, s)
  if (dtype == csn::kBF16) {
    if (D == 16) CSN_TC(16);
    if (D == 32) CSN_TC(32);
    if (D == 64) CSN_TC(64);
    if (D == 128) CSN_TC(128);
    if (D == 256)
      return csn_tcw::launch_fwd_split<256>(
          q, k, v, kv_mask, q_mask, out, lse, csn::Carry{}, B, H, Lq, Lk,
          inv_temp, drop, s);
  }
#undef CSN_TC
  if (dtype == csn::kF32 && D == csn_tf32_d64::D)
    return csn_tf32_d64::launch_fwd(q, k, v, kv_mask, q_mask, out, lse,
                                    csn::Carry{}, B, H, Lq, Lk, inv_temp,
                                    drop, s);
  if (dtype == csn::kF32 && D == csn_tf32_d128::D)
    return csn_tf32_d128::launch_fwd(q, k, v, kv_mask, q_mask, out, lse,
                                     csn::Carry{}, B, H, Lq, Lk, inv_temp,
                                     drop, s);
  if (dtype == csn::kF32 && D == csn_tf32::D)
    return csn_tf32::launch_fwd_tf32<false, false>(
        q, k, v, kv_mask, q_mask, out, lse, csn::Carry{}, B, H, Lq, Lk,
        inv_temp, drop, s);
  return cudaErrorInvalidValue;
}
