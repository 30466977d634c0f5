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
// What bounds it on the H100: as the full backward, seven tile products per
// (query tile, key tile) pair on the CUDA cores in f32: compute-bound.
//
// Design: the two deterministic passes of flash_bwd_wide.cuh with the dQ
// type set to float. The TPU kernel accumulates dQ over its whole sequential
// grid in a VMEM plane; across hops the sum is the caller's (ops/attention.py
// RingFlashAttentionFn adds the blocks' f32 terms).

#include "common.cuh"
#include "flash_bwd_wide.cuh"

// q, dout [B, H, Lq, D]; k, v, dk, dv [B, H, Lk, D] contiguous in one type;
// dq [B, H, Lq, D] f32; lse and delta [B, H, Lq] f32; kv_mask [B, Lk] and
// q_mask [B, Lq] bool bytes. D is 64, 128 or 256.
extern "C" int csn_flash_attn_block_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask,
    const void* q_mask, void* dq, void* dk, void* dv, int B, int H, int Lq,
    int Lk, int D, float inv_temp, uint64_t seed, uint32_t thresh,
    float inv_keep, int use_drop, int row_off, int col_off, void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csn_wide_bwd::Drop drop{seed,     thresh,  inv_keep,
                                use_drop, row_off, col_off};
#define CSN_BLOCK(T, DD)                                                     \
  return csn_wide_bwd::launch_bwd_wide<T, float, DD>(                        \
      q, k, v, dout, lse, delta, kv_mask, q_mask, dq, dk, dv, B, H, Lq, Lk, \
      inv_temp, drop, s)
  if (dtype == csn::kF32) {
    if (D == 64) CSN_BLOCK(float, 64);
    if (D == 128) CSN_BLOCK(float, 128);
    if (D == 256) CSN_BLOCK(float, 256);
  }
  if (dtype == csn::kBF16) {
    if (D == 64) CSN_BLOCK(__nv_bfloat16, 64);
    if (D == 128) CSN_BLOCK(__nv_bfloat16, 128);
    if (D == 256) CSN_BLOCK(__nv_bfloat16, 256);
  }
#undef CSN_BLOCK
  return cudaErrorInvalidValue;
}
