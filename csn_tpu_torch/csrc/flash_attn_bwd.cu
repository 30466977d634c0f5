// Masked flash attention backward (dQ, dK, dV from the saved log-sum-exp),
// with the forward's attention dropout regenerated in the kernel.
//
// Replaces: csn_tpu/ops/flash.py _flash_backward (Pallas body
// _bwd_fused_kernel), which the JAX package reaches through the custom VJP of
// flash_attention from ops/attention.py MultiHeadAttention.
//
// Computes, per (batch*head), with s = (q / T) . k masked to NEG_INF at
// invalid keys, p = exp(s - lse) (the true softmax), the dropout mask m and
// keep = 1 - rate (m = 1, keep = 1 without dropout), and delta = rowsum(dO o
// O) computed by the caller:
//   dP = dO . v^T,  dPd = m * dP / keep,  dS = p * (dPd - delta),
//   dV = (m * p / keep)^T . dO,  dK = dS^T . (q / T),  dQ = dS . k / T,
// accumulated in f32, stored in the type of q, k, v. Query tiles with no
// valid query and key tiles with no valid key are skipped, as in the forward
// (flash_attn.cu): a skipped key tile gets dK = dV = 0, a skipped query tile
// dQ = 0.
//
// What bounds it on the H100: seven 64x64x64 tile products per (query tile,
// key tile) pair (four in the dK/dV pass, three in the dQ pass) against the
// forward's two: compute-bound like the forward.
//
// Design: the classic two-pass split, deterministic and without atomics. The
// TPU kernel accumulates dQ in a VMEM-resident [Lq, D] plane across its
// sequential (key, query) grid; a block's shared memory has no room for that
// plane and blocks run in no order, so the work is split in two kernels:
//  * dkdv: one block per (batch*head, 64-key tile) keeps its K and V tile and
//    loops over the live query tiles;
//  * dq: one block per (batch*head, 64-query tile) keeps Q and dO and loops
//    over the live key tiles.
// dq recomputes s, p and dP that dkdv computed too: two of the seven tile
// products are spent on not sharing dQ across blocks.
//
// bf16, D = TD in {16, 32, 64} (64: the HRNet heads): every product on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators), in the
// layout of the forward (flash_tc_fwd.cuh), one template over TD
// (flash_tc_bwd.cuh, over flash_tc.cuh's blocks; its header states the
// design, and it holds the ring's block form too).
//
// bf16 at D = 128 and 256 (d_model 256 in 2 heads or 1; the MID-FC heads
// in bf16) run on the tensor cores in the layout of flash_tf32_bwd.cuh:
// warps that split D in quarters for S and dP and in eighths for dK, dV
// and dQ, dS^T handed to the dQ pass through a bf16 scratch
// (flash_bf16_wide_bwd.cuh): at 16 keys a warp, dK and dV over 128 dims
// would take 128 accumulator registers.
//
// f32 at D = 256 (the MID-FC heads), at D = 128 and at D = 64 (the HRNet
// heads with f32 activations at d_model 256 in 2 heads or 4) run on the
// tensor cores in split TF32 (three TF32 products per f32 product,
// f32-accurate): flash_tf32_bwd.cuh at 256 and 128 (dS^T handed to the dQ
// pass through an f32 scratch), flash_tf32_d64_bwd.cuh (dS recomputed in
// the dQ pass). Other head dims up to 256 come zero-padded by the wrapper
// (ops/flash.py) to the next width built here: the padded columns of dQ,
// dK and dV are cut off, delta is unchanged.

#include "common.cuh"
#include "flash_bf16_wide_bwd.cuh"
#include "flash_tc_bwd.cuh"
#include "flash_tf32_bwd.cuh"
#include "flash_tf32_d64_bwd.cuh"

// q, dout, dq: [B, H, Lq, D]; k, v, dk, dv: [B, H, Lk, D], all contiguous in
// one type and 16-byte aligned; lse and delta [B, H, Lq] f32; kv_mask [B, Lk]
// and q_mask [B, Lq] bool bytes. D is 16, 32, 64, 128 or 256 in bf16, 64,
// 128 or 256 in f32. Dropout arguments as
// csn_flash_attn_fwd's. ds_t: scratch of B * H * ceil32(Lk) * ceil32(Lq)
// elements in the type of q, through which the dK/dV pass hands dS^T to
// the dQ pass: f32 at D = 128 and 256 (flash_tf32_bwd.cuh), bf16 at D = 128
// and 256 (flash_bf16_wide_bwd.cuh); unused otherwise.
extern "C" int csn_flash_attn_bwd(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* kv_mask, const void* q_mask,
                                  void* dq, void* dk, void* dv, void* ds_t,
                                  int B, int H, int Lq, int Lk, int D,
                                  float inv_temp, uint64_t seed,
                                  uint32_t thresh, float inv_keep,
                                  int use_drop, void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csn::Drop wd{seed, thresh, inv_keep, use_drop, 0, 0};
#define CSN_TC(DD)                                                     \
  return csn_tc_bwd::launch_tc<DD>(q, k, v, dout, lse, delta, kv_mask, \
                                   q_mask, dq, dk, dv, B, H, Lq, Lk,   \
                                   inv_temp, wd, s)
  if (dtype == csn::kBF16) {
    if (D == 16) CSN_TC(16);
    if (D == 32) CSN_TC(32);
    if (D == 64) CSN_TC(64);
  }
#undef CSN_TC
  if (dtype == csn::kBF16 && (D == 128 || D == 256))
    return D == 128 ? csn_tcw::launch_bwd_split<128>(
                          q, k, v, dout, lse, delta, kv_mask, q_mask, dq, dk,
                          dv, ds_t, B, H, Lq, Lk, inv_temp, wd, s)
                    : csn_tcw::launch_bwd_split<256>(
                          q, k, v, dout, lse, delta, kv_mask, q_mask, dq, dk,
                          dv, ds_t, B, H, Lq, Lk, inv_temp, wd, s);
  if (dtype == csn::kF32 && D == csn_tf32_d64::D)
    return csn_tf32_d64::launch_bwd(q, k, v, dout, lse, delta, kv_mask,
                                    q_mask, dq, dk, dv, B, H, Lq, Lk,
                                    inv_temp, wd, s);
  if (dtype == csn::kF32 && D == csn_tf32::D)
    return csn_tf32::launch_bwd_tf32<float>(q, k, v, dout, lse, delta,
                                            kv_mask, q_mask, dq, dk, dv,
                                            ds_t, B, H, Lq, Lk, inv_temp,
                                            wd, s);
  if (dtype == csn::kF32 && D == 128)
    return csn_tf32::launch_bwd_tf32<float, 128>(q, k, v, dout, lse, delta,
                                                 kv_mask, q_mask, dq, dk, dv,
                                                 ds_t, B, H, Lq, Lk,
                                                 inv_temp, wd, s);
  return cudaErrorInvalidValue;
}
