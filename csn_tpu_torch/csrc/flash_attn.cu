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
// (flash_tc.cuh: TD / 16 k-steps of S, TD / 8 n-tiles of O). One block of
// 4 warps per
// (batch*head, 64-query tile); each warp owns 16 query rows. Q, K and V
// tiles go global -> shared by cp.async into [64][TD + 8] tiles (padded
// rows: ldmatrix without bank conflicts), K and V double-buffered, so the
// next live key tile's copy runs under this tile's products; one barrier
// per key tile, the key mask read a tile ahead. Q's A fragments are loaded
// once (ldmatrix) and kept in registers. S = Q K^T runs on mma.sync
// m16n8k16 (bf16 in, f32 accumulate); 1/temperature multiplies the f32
// scores (not Q before rounding), folded with log2(e) so the softmax runs
// on exp2. At TD = 128 a lane holds 64 f32 accumulators of O and the
// tiles take 87 KB of (dynamic) shared memory: two blocks per SM. The
// running
// max and denominator of a row live in the four lanes that hold it (quad
// shuffles), the denominator summed per lane and reduced once at the end.
// P is rounded to bf16 only as the A operand of O += P V (ldmatrix.trans of
// the V tile for B), which accumulates in f32 registers. Dropout: a lane
// holds two adjacent columns of a fragment row, half a Philox group; lanes
// t and t^1 share one group, so each draws it for one of the two rows it
// serves and they swap words (flash_tc.cuh drop_words): one Philox call per
// 4 entries, as the mask has. The next step for this kernel is wgmma with
// TMA (ROADMAP B2).
//
// f32 at D = 256 (the MID-FC heads), at D = 128 (the HRNet heads with f32
// activations at d_model 256 in 2 heads) and at D = 64 (in 4 heads): the
// tensor cores in split TF32, three TF32 products per f32 product
// (flash_tf32_fwd.cuh, flash_tf32_d128_fwd.cuh, flash_tf32_d64_fwd.cuh):
// one TF32 product would miss the f32 checks' 1e-4, three hold it. No K2
// case is left on the CUDA-core kernel of flash_wide.cuh.
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
#include "flash_tc.cuh"
#include "flash_tf32_d128_fwd.cuh"
#include "flash_tf32_d64_fwd.cuh"
#include "flash_tf32_fwd.cuh"

namespace {

using namespace csn_tc;

constexpr int THREADS = 128;  // 4 warps x 16 query rows

template <int TD>
struct FwdSmem {
  bf16 q[TILE * lds_of(TD)];
  bf16 k[2][TILE * lds_of(TD)];
  bf16 v[2][TILE * lds_of(TD)];
  float kval[2][TILE];  // key flags of the tile in each buffer
};

// The tiles of TD <= 64 in static shared memory (46 KB at 64); TD = 128's
// 87 KB only fit as dynamic shared memory.
template <int TD>
__host__ __device__ constexpr int fwd_dyn_smem() {
  return sizeof(FwdSmem<TD>) <= 48 * 1024 ? 0 : (int)sizeof(FwdSmem<TD>);
}

template <int TD>
__device__ __forceinline__ FwdSmem<TD>& fwd_smem() {
  if constexpr (fwd_dyn_smem<TD>() == 0) {
    __shared__ __align__(128) FwdSmem<TD> sm;
    return sm;
  } else {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    return *reinterpret_cast<FwdSmem<TD>*>(smem_raw);
  }
}

// four blocks per SM up to TD = 64 (128 registers a thread at TD = 64):
// faster than three with the registers the compiler would take otherwise;
// two at TD = 128, as many as its shared memory allows
template <int TD>
__global__ void __launch_bounds__(THREADS, TD <= 64 ? 4 : 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const uint8_t* __restrict__ kv_mask,
                    const uint8_t* __restrict__ q_mask, bf16* __restrict__ out,
                    float* __restrict__ lse, int H, int Lq, int Lk,
                    float inv_temp, uint64_t seed, uint32_t thresh,
                    float inv_keep, int use_drop) {
  FwdSmem<TD>& sm = fwd_smem<TD>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * TILE;
  const bf16* qp = q + (int64_t)bh * Lq * TD;
  const bf16* kp = k + (int64_t)bh * Lk * TD;
  const bf16* vp = v + (int64_t)bh * Lk * TD;
  bf16* op = out + (int64_t)bh * Lq * TD;
  float* lp = lse + (int64_t)bh * Lq;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;

  int qlive = 0;
  if (tid < TILE) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // padding tile: zeros
    for (int i = tid; i < TILE * TD / 2; i += THREADS) {
      const int r = q0 + i / (TD / 2);
      if (r < Lq)
        reinterpret_cast<uint32_t*>(op + (int64_t)r * TD)[i % (TD / 2)] = 0u;
    }
    if (tid < TILE && q0 + tid < Lq) lp[q0 + tid] = NEG_INF + logf(1e-30f);
    return;
  }

  // The key-tile loop: one barrier per tile (find_live's), which both
  // publishes the tile whose copy this thread waited for and orders every
  // warp's reads of the other buffer before it is refilled. The mask bytes
  // of the tile after next are loaded a tile ahead (pre).
  const int nt = (Lk + TILE - 1) / TILE;
  load_tile<TD>(sm.q, qp, q0, Lq, tid, THREADS);
  int live = row_live(km, Lk, 0, tid);
  int kt = find_live(0, nt, live, km, Lk, tid);
  if (kt < nt) {
    if (tid < TILE) sm.kval[0][tid] = live ? 1.f : 0.f;
    load_tile<TD>(sm.k[0], kp, kt * TILE, Lk, tid, THREADS);
    load_tile<TD>(sm.v[0], vp, kt * TILE, Lk, tid, THREADS);
  }
  cp_async_commit();
  int pre = row_live(km, Lk, kt + 1, tid);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[TD / 16][4];
  load_a<TD>(qf, sm.q, warp * 16, lane);

  const float sc = inv_temp * LOG2E;  // scores in log2 units
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[TD / 8][4];
#pragma unroll
  for (int i = 0; i < TD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  const uint32_t row = (uint32_t)(q0 + warp * 16 + g);

  for (int buf = 0; kt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) {  // the next live tile's copy runs under this one
      if (tid < TILE) sm.kval[buf ^ 1][tid] = pre ? 1.f : 0.f;
      load_tile<TD>(sm.k[buf ^ 1], kp, next * TILE, Lk, tid, THREADS);
      load_tile<TD>(sm.v[buf ^ 1], vp, next * TILE, Lk, tid, THREADS);
      cp_async_commit();
    }
    pre = row_live(km, Lk, next + 1, tid);

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    mma_abt<TD>(s, qf, sm.k[buf], lane);

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = sm.kval[buf][nb * 8 + 2 * t + (e & 1)] != 0.f;
        s[nb][e] = ok ? s[nb][e] * sc : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float scale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      scale[h] = exp2_approx(m[h] - m_new);
      m[h] = m_new;
      l[h] *= scale[h];
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2_approx(s[nb][e] - m[e >> 1]);
        l[e >> 1] += s[nb][e];  // undropped: the denominator
      }
#pragma unroll
    for (int nb = 0; nb < TD / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][e] *= scale[e >> 1];
    if (use_drop) {  // numerator only
      const uint32_t kb = keep_bits(seed, (uint32_t)bh, row,
                                    (uint32_t)(kt * TILE), thresh, t);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nb][e] = (kb >> (4 * nb + e)) & 1u ? s[nb][e] * inv_keep : 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      c_to_a(a, s, ks);
      mma_ab_step<TD>(o, a, sm.v[buf], ks, lane);
    }
    kt = next;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = (int)row + 8 * h;
    if (r >= Lq) continue;
    const float den = fmaxf(l[h], 1e-30f);
    const float inv = 1.f / den;
#pragma unroll
    for (int nb = 0; nb < TD / 8; ++nb)
      *reinterpret_cast<uint32_t*>(op + (int64_t)r * TD + nb * 8 + 2 * t) =
          pack(o[nb][2 * h] * inv, o[nb][2 * h + 1] * inv);
    if (t == 0)
      lp[r] = (m[h] <= NEG_INF ? NEG_INF : m[h] * LN2) + logf(den);
  }
}

template <int TD>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* kv_mask, const void* q_mask, void* out,
                      void* lse, int B, int H, int Lq, int Lk, float inv_temp,
                      uint64_t seed, uint32_t thresh, float inv_keep,
                      int use_drop, cudaStream_t stream) {
  constexpr int smem = fwd_dyn_smem<TD>();
  if (smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<TD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((Lq + TILE - 1) / TILE), (unsigned)(B * H));
  flash_fwd_tc_kernel<TD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Lq, Lk, inv_temp, seed, thresh, inv_keep,
      use_drop);
  return cudaGetLastError();
}

}  // namespace

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
#define CSN_TC(DD)                                                         \
  return launch_tc<DD>(q, k, v, kv_mask, q_mask, out, lse, B, H, Lq, Lk, \
                       inv_temp, seed, thresh, inv_keep, use_drop, s)
  if (dtype == csn::kBF16) {
    if (D == 16) CSN_TC(16);
    if (D == 32) CSN_TC(32);
    if (D == 64) CSN_TC(64);
    if (D == 128) CSN_TC(128);
    if (D == 256)
      return csn_tcw::launch_fwd_split<256>(
          q, k, v, kv_mask, q_mask, out, lse, csn_tf32::Carry{}, B, H, Lq,
          Lk, inv_temp, csn_tf32::Drop{seed, thresh, inv_keep, use_drop, 0, 0},
          s);
  }
#undef CSN_TC
  if (dtype == csn::kF32 && D == csn_tf32_d64::D)
    return csn_tf32_d64::launch_fwd(
        q, k, v, kv_mask, q_mask, out, lse, B, H, Lq, Lk, inv_temp,
        csn_tf32::Drop{seed, thresh, inv_keep, use_drop, 0, 0}, s);
  if (dtype == csn::kF32 && D == csn_tf32_d128::D)
    return csn_tf32_d128::launch_fwd(
        q, k, v, kv_mask, q_mask, out, lse, B, H, Lq, Lk, inv_temp,
        csn_tf32::Drop{seed, thresh, inv_keep, use_drop, 0, 0}, s);
  if (dtype == csn::kF32 && D == csn_tf32::D)
    return csn_tf32::launch_fwd_tf32<false, false>(
        q, k, v, kv_mask, q_mask, out, lse, csn_tf32::Carry{}, B, H, Lq, Lk,
        inv_temp, csn_tf32::Drop{seed, thresh, inv_keep, use_drop, 0, 0}, s);
  return cudaErrorInvalidValue;
}
