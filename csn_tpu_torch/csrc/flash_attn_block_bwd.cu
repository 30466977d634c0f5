// Flash attention backward for one key block of a ring: this block's dK and
// dV, and its contribution to dQ in f32.
//
// Replaces: csn_tpu/ops/flash.py flash_block_backward (the Pallas body
// _bwd_fused_kernel run on one kv block), which the JAX package reaches
// through the custom VJP of ops/attention.py ring_flash_attention
// (_ring_flash_bwd).
//
// Computes flash_attn_bwd.cu's function restricted to the keys of one block,
// given the GLOBAL log-sum-exp rows, delta = rowsum(dO o O) of the global
// output, and dO: p = exp(s - lse) is then each entry's share of the full
// softmax, so the per-block dK and dV are final, and the per-block dQ terms
// add up to the full dQ. dQ is returned in f32 so that the sum over hops
// loses nothing in bf16 runs; dK and dV keep the activation type. The dropout
// mask is keyed by absolute (query row, key column): row_off and col_off give
// this block's place in the global score matrix.
//
// f32 at D = 256 (the MID-FC heads, the ring's shape) and D = 128 (the
// MID-FC heads at d_model 128): the split-TF32 passes of
// flash_tf32_bwd.cuh on the tensor cores at that head dim, with the block's
// offsets and an f32 dQ term; the dK/dV pass hands dS^T to the dQ pass
// through the caller's f32 scratch of ceil32(Lk) x ceil32(Lq) per
// (batch*head) (6.4 GB for one hop over all 10000 keys at B = 2, 8 heads,
// at either head dim; a ring of N ranks has Lk / N keys per hop). What
// bounds it: products, five D-long ones per (query, key) pair, three TF32
// products each.
// bf16 at D = 256 and 128 (the MID-FC heads with compute_dtype
// "bfloat16"): the two passes of flash_bf16_wide_bwd.cuh on the tensor
// cores (mma.sync m16n8k16, f32 accumulators) with the block's offsets and
// the dQ type set to float; the dK/dV pass hands dS^T, rounded to bf16, to
// the dQ pass through the caller's bf16 scratch of ceil32(Lk) x ceil32(Lq)
// per (batch*head) (3.2 GB for one hop over all 10000 keys at B = 2, 8
// heads; its round trip, about 1.9 ms at 3.35 TB/s, is stated in that
// header).
// f32 and bf16 at D = 64 (the MID-FC heads at d_model 64; a ring at d_k
// below 64 comes zero-padded to 64): the two passes of K2's D = 64 body of
// each dtype on the tensor cores with the block's offsets and an f32 dQ
// term, f32 in split TF32 (flash_tf32_d64_bwd.cuh), bf16 on mma.sync
// m16n8k16 (flash_tc_bwd.cuh's template); both recompute dS in the dQ pass
// and take no scratch. What bounds them: the same five D-long products per
// (query, key) pair, and the per-entry work (exp2, the Philox words) twice,
// which does not shrink with D.
// The TPU kernel accumulates dQ over its whole sequential grid in a VMEM
// plane; across hops the sum is the caller's (ops/attention.py
// RingFlashAttentionFn adds the blocks' f32 terms), so the dQ pass stores
// the block's term and adds nothing itself.

#include "common.cuh"
#include "flash_bf16_wide_bwd.cuh"
#include "flash_tc_bwd.cuh"
#include "flash_tf32_bwd.cuh"
#include "flash_tf32_d64_bwd.cuh"

// q, dout [B, H, Lq, D]; k, v, dk, dv [B, H, Lk, D] contiguous in one type
// and 16-byte aligned; dq [B, H, Lq, D] f32; lse and delta [B, H, Lq] f32;
// kv_mask [B, Lk] and q_mask [B, Lq] bool bytes. D is 64, 128 or 256. ds_t:
// scratch of B * H * ceil32(Lk) * ceil32(Lq) elements in the type of q at
// D = 128 and 256 (f32: flash_tf32_bwd.cuh, bf16: flash_bf16_wide_bwd.cuh),
// unused at 64. Returns the first CUDA error of the one body its (dtype, D)
// selects.
extern "C" int csn_flash_attn_block_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask,
    const void* q_mask, void* dq, void* dk, void* dv, void* ds_t, int B,
    int H, int Lq, int Lk, int D, float inv_temp, uint64_t seed,
    uint32_t thresh, float inv_keep, int use_drop, int row_off, int col_off,
    void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csn::Drop drop{seed, thresh, inv_keep, use_drop, row_off, col_off};
  // the dropout words of keep_bits need a key tile on a multiple of 4
  // columns (the bodies at 128 and 256 draw theirs at any)
  const bool any_col = use_drop && col_off % 4 != 0;
  if (dtype == csn::kF32 && D == 256)
    return csn_tf32::launch_bwd_tf32<float>(q, k, v, dout, lse, delta,
                                            kv_mask, q_mask, dq, dk, dv,
                                            ds_t, B, H, Lq, Lk, inv_temp,
                                            drop, s);
  if (dtype == csn::kF32 && D == 128)
    return csn_tf32::launch_bwd_tf32<float, 128>(q, k, v, dout, lse, delta,
                                                 kv_mask, q_mask, dq, dk, dv,
                                                 ds_t, B, H, Lq, Lk,
                                                 inv_temp, drop, s);
  if (dtype == csn::kBF16 && D == 256)
    return csn_tcw::launch_bwd_split<256, float>(q, k, v, dout, lse, delta,
                                                 kv_mask, q_mask, dq, dk, dv,
                                                 ds_t, B, H, Lq, Lk, inv_temp,
                                                 drop, s);
  if (dtype == csn::kBF16 && D == 128)
    return csn_tcw::launch_bwd_split<128, float>(q, k, v, dout, lse, delta,
                                                 kv_mask, q_mask, dq, dk, dv,
                                                 ds_t, B, H, Lq, Lk, inv_temp,
                                                 drop, s);
  if (dtype == csn::kF32 && D == 64)
    return any_col ? csn_tf32_d64::launch_bwd<true, true>(
                         q, k, v, dout, lse, delta, kv_mask, q_mask, dq, dk,
                         dv, B, H, Lq, Lk, inv_temp, drop, s)
                   : csn_tf32_d64::launch_bwd<true, false>(
                         q, k, v, dout, lse, delta, kv_mask, q_mask, dq, dk,
                         dv, B, H, Lq, Lk, inv_temp, drop, s);
  if (dtype == csn::kBF16 && D == 64)
    return any_col ? csn_tc_bwd::launch_tc<64, true, true>(
                         q, k, v, dout, lse, delta, kv_mask, q_mask, dq, dk,
                         dv, B, H, Lq, Lk, inv_temp, drop, s)
                   : csn_tc_bwd::launch_tc<64, true, false>(
                         q, k, v, dout, lse, delta, kv_mask, q_mask, dq, dk,
                         dv, B, H, Lq, Lk, inv_temp, drop, s);
  return cudaErrorInvalidValue;
}
