// The bf16 flash attention backward on the tensor cores at head dims TD =
// 16, 32 and 64, one template over TD (flash_tc.cuh's building blocks), in
// two forms: K2's backward (flash_attn_bwd.cu), and the block form of the
// ring's per-hop backward (flash_attn_block_bwd.cu), at TD = 64 the MID-FC
// full attention in bf16 at d_model 64 (8 heads of 64; a ring at d_k below
// 64 comes zero-padded to 64).
//
// Replaces: csn_tpu/ops/flash.py _flash_backward (Pallas body
// _bwd_fused_kernel) at bf16 heads up to 64 (64: the HRNet heads, d_model
// 256 in 4 heads); and flash_block_backward (the same Pallas body on one kv
// block), which the JAX package reaches through the custom VJP of
// ops/attention.py ring_flash_attention, at bf16 heads of 64.
//
// Function, dropout and bound as flash_attn_bwd.cu states. Every product on
// the tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators), in
// the layout of the forward (flash_tc_fwd.cuh). Blocks of 4 warps; the
// streamed tiles go global -> shared by cp.async, double-buffered, into
// [64][TD + 8] tiles read by ldmatrix; the score tiles are 64 keys wide at
// every TD.
//  * dkdv: each warp computes S and dP for 16 queries of the tile against
//    the block's 64 keys (Q and dO A fragments by ldmatrix, K and V as B).
//    P, the dropout, and dS follow in f32 registers; m * P / keep and dS are
//    then rounded to bf16 into two [64][72] shared tiles, which is the only
//    place they are rounded. After a barrier each warp owns 16 keys: dV +=
//    (m P / keep)^T . dO and dK += dS^T . Q, the transposed A operands read
//    off those tiles by ldmatrix.trans (no second copy), dO and Q as B by
//    ldmatrix.trans. dK takes 1/T once at the end.
//  * dq: each warp owns 16 queries; Q and dO A fragments stay in registers
//    for the whole key loop; S, dP and dS as above, then dS, rounded to bf16
//    in registers (never through shared memory), is the A operand of dQ +=
//    dS . K (K as B by ldmatrix.trans). dQ takes 1/T at the end.
// dS is recomputed in the dQ pass rather than handed over through a scratch
// (as the bodies at 128 and 256 do): at TD <= 64 the two recomputed
// products are a small share of a tile pair's work.
// Dropout words as the forward draws them (flash_tc.cuh drop_words).
//
// The block form (BLOCK) runs the same two passes on one key block of a
// ring, given the GLOBAL lse, delta and dO: the dropout words are keyed by
// absolute (batch*head, row_off + row, col_off + column), through
// keep_bits_any (ANY_COL; flash_tc.cuh) where the block starts off a
// multiple of 4 columns, and the dQ pass stores the block's term in f32
// (DqType), which the caller adds over the hops in f32 (ops/attention.py
// RingFlashAttentionFn); dK and dV stay bf16. K2's form (BLOCK false) is
// the same code with the offsets compiled out and a bf16 dQ. The kernels
// and their launcher have internal linkage: both entry points include this
// file.

#pragma once

#include <type_traits>

#include "flash_tc.cuh"

namespace csn_tc_bwd {
namespace {

using namespace csn_tc;
using Drop = csn::Drop;

constexpr int THREADS = 128;  // 4 warps

template <int TD>
struct DkdvSmem {
  bf16 k[TILE * lds_of(TD)];
  bf16 v[TILE * lds_of(TD)];
  bf16 q[2][TILE * lds_of(TD)];
  bf16 dout[2][TILE * lds_of(TD)];
  bf16 p[TILE * LDS];   // m * p / keep, [query][key]
  bf16 ds[TILE * LDS];  // dS, [query][key]
  float kval[TILE];
};

template <int TD>
struct DqSmem {
  bf16 q[TILE * lds_of(TD)];
  bf16 dout[TILE * lds_of(TD)];
  bf16 k[2][TILE * lds_of(TD)];
  bf16 v[2][TILE * lds_of(TD)];
  float kval[2][TILE];
};

// p, m * p / keep and dS of one warp's 16 x 64 score tile, in place: s and
// dp hold S (raw q . k) and dP on entry, m p / keep and dS on exit. kval:
// the tile's key flags; kb: the lane's keep bits (keep_bits).
__device__ __forceinline__ void probs_and_ds(
    float (&s)[8][4], float (&dp)[8][4], const float* kval, float sc,
    const float (&lse2)[2], const float (&dl)[2], const Drop& drop,
    uint32_t kb, int t) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = kval[nb * 8 + 2 * t + (e & 1)] != 0.f
                          ? exp2_approx(s[nb][e] * sc - lse2[h])
                          : 0.f;
      float dpd = dp[nb][e], pd = p;
      if (drop.on) {
        const bool keep = (kb >> (4 * nb + e)) & 1u;
        dpd = keep ? dpd * drop.inv_keep : 0.f;
        pd = keep ? p * drop.inv_keep : 0.f;
      }
      s[nb][e] = pd;
      dp[nb][e] = p * (dpd - dl[h]);
    }
  }
}

// The lane's keep bits of its warp's 16 x 64 tile, query rows `row` (+ 8)
// and keys col0 .. col0 + 63 of the launch (keep_bits' layout): K2's at
// those positions, the block form's at (row_off + row, col_off + col0) in
// the global score matrix, through keep_bits_any where the key block starts
// off a multiple of 4 columns (ANY_COL). 0 without dropout.
template <bool BLOCK, bool ANY_COL>
__device__ __forceinline__ uint32_t tile_keep_bits(const Drop& drop,
                                                   uint32_t bh, int row,
                                                   int col0, int t) {
  if (!drop.on) return 0u;
  if constexpr (!BLOCK) {
    return keep_bits(drop.seed, bh, (uint32_t)row, (uint32_t)col0,
                     drop.thresh, t);
  } else {
    const uint32_t grow = (uint32_t)(drop.row_off + row);
    const uint32_t col = (uint32_t)(drop.col_off + col0);
    return ANY_COL ? keep_bits_any(drop.seed, bh, grow, col, drop.thresh, t)
                   : keep_bits(drop.seed, bh, grow, col, drop.thresh, t);
  }
}

// lse (in log2 units) and delta of the lane's rows row and row + 8; 0 past
// L (those rows carry q = dO = 0, so they add nothing)
__device__ __forceinline__ void row_stats(float (&lse2)[2], float (&dl)[2],
                                          const float* lse, const float* delta,
                                          int row, int L) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row + 8 * h < L;
    lse2[h] = in ? lse[row + 8 * h] * LOG2E : 0.f;
    dl[h] = in ? delta[row + 8 * h] : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// two neighbouring entries of an output row: bf16 (dK, dV, K2's dQ) or f32
// (the block form's dQ term)
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// rows row0 + g (+ 8) of a [L, TD] matrix from a warp's accumulator, times f
template <int TD, typename T>
__device__ __forceinline__ void store_rows(T* dst,
                                           const float (&x)[TD / 8][4],
                                           int row0, int L, float f, int g,
                                           int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= L) continue;
#pragma unroll
    for (int nb = 0; nb < TD / 8; ++nb)
      store_pair(dst + (int64_t)r * TD + nb * 8 + 2 * t, x[nb][2 * h] * f,
                 x[nb][2 * h + 1] * f);
  }
}

// rows row0 .. row0 + 63 (those below L) of a [L, TD] matrix set to zero
template <int TD, typename T>
__device__ __forceinline__ void zero_rows(T* dst, int row0, int L,
                                          int tid) {
  for (int i = tid; i < TILE * TD / 2; i += THREADS) {
    const int r = row0 + i / (TD / 2);
    if (r < L) store_pair(dst + (int64_t)r * TD + 2 * (i % (TD / 2)), 0.f, 0.f);
  }
}

// --- dK, dV: one block per (batch*head, key tile) ---------------------------

// K2's kernels are held to three blocks per SM (168 registers a thread at
// TD = 64, no spills): faster than the two the compiler's own choice
// allows. The block form's dK/dV pass spills at three (84 bytes; 384 on
// its ANY_COL path) and takes two (241 and 255 registers, no spills); its
// dQ pass keeps three but on the ANY_COL path (320 bytes of spills), which
// takes two (238). At the ring of one [2, 8, 10000, 64], dropout 0.1, an
// H100 ran this choice in 7.60 ms, the dK/dV pass at three blocks in 7.90,
// the dQ pass at two in 7.78. BLOCK: the block form (the rows and keys at
// drop.row_off / col_off of the global score matrix); ANY_COL: its key
// block starts off a multiple of 4 columns.
template <int TD, bool BLOCK, bool ANY_COL>
__global__ void __launch_bounds__(THREADS, BLOCK ? 2 : 3)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const uint8_t* __restrict__ kv_mask,
                         const uint8_t* __restrict__ q_mask,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int Lq, int Lk, float inv_temp, Drop drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkdvSmem<TD>& sm = *reinterpret_cast<DkdvSmem<TD>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int kv0 = blockIdx.x * TILE;
  const bf16* qp = q + (int64_t)bh * Lq * TD;
  const bf16* dop = dout + (int64_t)bh * Lq * TD;
  const float* lp = lse + (int64_t)bh * Lq;
  const float* dlp = delta + (int64_t)bh * Lq;
  const uint8_t* qm = q_mask + (int64_t)b * Lq;

  int live = 0;
  if (tid < TILE) {
    const int r = kv0 + tid;
    live = r < Lk && kv_mask[(int64_t)b * Lk + r];
    sm.kval[tid] = live ? 1.f : 0.f;
  }
  if (!__syncthreads_or(live)) {  // no valid key: dK = dV = 0
    zero_rows<TD>(dk + (int64_t)bh * Lk * TD, kv0, Lk, tid);
    zero_rows<TD>(dv + (int64_t)bh * Lk * TD, kv0, Lk, tid);
    return;
  }
  // The query-tile loop, as the forward's key loop (flash_attn.cu): one
  // barrier in find_live per tile, which publishes the Q and dO tile this
  // thread waited for and orders the previous tile's reads of the other
  // buffers and of the P and dS tiles before they are refilled; a second
  // barrier publishes P and dS. Mask bytes, lse and delta are loaded a tile
  // ahead.
  const int nt = (Lq + TILE - 1) / TILE;
  load_tile<TD>(sm.k, k + (int64_t)bh * Lk * TD, kv0, Lk, tid, THREADS);
  load_tile<TD>(sm.v, v + (int64_t)bh * Lk * TD, kv0, Lk, tid, THREADS);
  int pre = row_live(qm, Lq, 0, tid);
  int qt = find_live(0, nt, pre, qm, Lq, tid);
  if (qt < nt) {
    load_tile<TD>(sm.q[0], qp, qt * TILE, Lq, tid, THREADS);
    load_tile<TD>(sm.dout[0], dop, qt * TILE, Lq, tid, THREADS);
  }
  cp_async_commit();
  pre = row_live(qm, Lq, qt + 1, tid);
  float lse2[2], dl[2];
  row_stats(lse2, dl, lp, dlp, qt * TILE + warp * 16 + g, Lq);

  const float sc = inv_temp * LOG2E;
  float acc_k[TD / 8][4], acc_v[TD / 8][4];
  zero_acc(acc_k);
  zero_acc(acc_v);
  for (int buf = 0; qt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live(qt + 1, nt, pre, qm, Lq, tid);
    if (next < nt) {
      load_tile<TD>(sm.q[buf ^ 1], qp, next * TILE, Lq, tid, THREADS);
      load_tile<TD>(sm.dout[buf ^ 1], dop, next * TILE, Lq, tid, THREADS);
      cp_async_commit();
    }
    pre = row_live(qm, Lq, next + 1, tid);
    float lse2_n[2], dl_n[2];
    row_stats(lse2_n, dl_n, lp, dlp, next * TILE + warp * 16 + g, Lq);

    // S and dP of this warp's 16 queries against the block's 64 keys
    const int row = qt * TILE + warp * 16 + g;
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    {
      uint32_t af[TD / 16][4];
      load_a<TD>(af, sm.q[buf], warp * 16, lane);
      mma_abt<TD>(s, af, sm.k, lane);
      load_a<TD>(af, sm.dout[buf], warp * 16, lane);
      mma_abt<TD>(dp, af, sm.v, lane);
    }
    const uint32_t kb =
        tile_keep_bits<BLOCK, ANY_COL>(drop, (uint32_t)bh, row, kv0, t);
    probs_and_ds(s, dp, sm.kval, sc, lse2, dl, drop, kb, t);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int o = (warp * 16 + g + 8 * h) * LDS + nb * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(sm.p + o) =
            pack(s[nb][2 * h], s[nb][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(sm.ds + o) =
            pack(dp[nb][2 * h], dp[nb][2 * h + 1]);
      }
    __syncthreads();

    // this warp's 16 keys: dV += (m P / keep)^T dO, dK += dS^T Q
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      load_a_t(a, sm.p, warp * 16, ks, lane);
      mma_ab_step<TD>(acc_v, a, sm.dout[buf], ks, lane);
      load_a_t(a, sm.ds, warp * 16, ks, lane);
      mma_ab_step<TD>(acc_k, a, sm.q[buf], ks, lane);
    }
    qt = next;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse2[h] = lse2_n[h];
      dl[h] = dl_n[h];
    }
  }
  const int r0 = kv0 + warp * 16;
  store_rows<TD>(dk + (int64_t)bh * Lk * TD, acc_k, r0, Lk, inv_temp, g, t);
  store_rows<TD>(dv + (int64_t)bh * Lk * TD, acc_v, r0, Lk, 1.f, g, t);
}

// --- dQ: one block per (batch*head, query tile) -----------------------------

// dq: bf16 for K2, f32 for the block form (its term of dQ, which the
// caller adds over the hops in f32)
template <bool BLOCK>
using DqType = std::conditional_t<BLOCK, float, bf16>;

template <int TD, bool BLOCK, bool ANY_COL>
__global__ void __launch_bounds__(THREADS, BLOCK && ANY_COL ? 2 : 3)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const uint8_t* __restrict__ kv_mask,
                       const uint8_t* __restrict__ q_mask,
                       DqType<BLOCK>* __restrict__ dq, int H, int Lq,
                       int Lk, float inv_temp, Drop drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem<TD>& sm = *reinterpret_cast<DqSmem<TD>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * TILE;
  const bf16* kp = k + (int64_t)bh * Lk * TD;
  const bf16* vp = v + (int64_t)bh * Lk * TD;
  DqType<BLOCK>* dqp = dq + (int64_t)bh * Lq * TD;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;

  int qlive = 0;
  if (tid < TILE) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // no valid query: dQ = 0
    zero_rows<TD>(dqp, q0, Lq, tid);
    return;
  }
  const int nt = (Lk + TILE - 1) / TILE;
  load_tile<TD>(sm.q, q + (int64_t)bh * Lq * TD, q0, Lq, tid, THREADS);
  load_tile<TD>(sm.dout, dout + (int64_t)bh * Lq * TD, q0, Lq, tid, THREADS);
  int live = row_live(km, Lk, 0, tid);
  int kt = find_live(0, nt, live, km, Lk, tid);
  if (kt < nt) {
    if (tid < TILE) sm.kval[0][tid] = live ? 1.f : 0.f;
    load_tile<TD>(sm.k[0], kp, kt * TILE, Lk, tid, THREADS);
    load_tile<TD>(sm.v[0], vp, kt * TILE, Lk, tid, THREADS);
  }
  cp_async_commit();
  int pre = row_live(km, Lk, kt + 1, tid);
  const int row = q0 + warp * 16 + g;
  float lse2[2], dl[2];
  row_stats(lse2, dl, lse + (int64_t)bh * Lq, delta + (int64_t)bh * Lq, row,
            Lq);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[TD / 16][4], gf[TD / 16][4];
  load_a<TD>(qf, sm.q, warp * 16, lane);
  load_a<TD>(gf, sm.dout, warp * 16, lane);

  const float sc = inv_temp * LOG2E;
  float acc[TD / 8][4];
  zero_acc(acc);
  for (int buf = 0; kt < nt; buf ^= 1) {  // the forward's key loop
    cp_async_wait<0>();
    const int next = find_live(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) {
      if (tid < TILE) sm.kval[buf ^ 1][tid] = pre ? 1.f : 0.f;
      load_tile<TD>(sm.k[buf ^ 1], kp, next * TILE, Lk, tid, THREADS);
      load_tile<TD>(sm.v[buf ^ 1], vp, next * TILE, Lk, tid, THREADS);
      cp_async_commit();
    }
    pre = row_live(km, Lk, next + 1, tid);

    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_abt<TD>(s, qf, sm.k[buf], lane);
    mma_abt<TD>(dp, gf, sm.v[buf], lane);
    const uint32_t kb = tile_keep_bits<BLOCK, ANY_COL>(drop, (uint32_t)bh,
                                                       row, kt * TILE, t);
    probs_and_ds(s, dp, sm.kval[buf], sc, lse2, dl, drop, kb, t);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // dQ += dS . K
      uint32_t a[4];
      c_to_a(a, dp, ks);
      mma_ab_step<TD>(acc, a, sm.k[buf], ks, lane);
    }
    kt = next;
  }
  store_rows<TD>(dqp, acc, q0 + warp * 16, Lq, inv_temp, g, t);
}

// Both passes on bf16 q, k, v, dout [B, H, L, TD] (16-byte aligned), lse
// and delta [B, H, Lq] f32: dk, dv bf16 and dq in DqType. K2 (BLOCK false:
// dq bf16, drop.row_off and col_off unused) or the block form (dq f32;
// drop.row_off / col_off place the rows and keys in the global score
// matrix; ANY_COL when dropout is on and drop.col_off % 4 != 0). Returns
// the first CUDA error; never another kernel. Each entry point
// instantiates only the forms it launches (flash_attn_bwd.cu K2,
// flash_attn_block_bwd.cu the block form).
template <int TD, bool BLOCK = false, bool ANY_COL = false>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* kv_mask, const void* q_mask, void* dq,
                      void* dk, void* dv, int B, int H, int Lq, int Lk,
                      float inv_temp, const Drop& drop, cudaStream_t stream) {
  constexpr int smem_kv = (int)sizeof(DkdvSmem<TD>);
  constexpr int smem_q = (int)sizeof(DqSmem<TD>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_tc_kernel<TD, BLOCK, ANY_COL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<TD, BLOCK, ANY_COL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  const uint8_t* km = static_cast<const uint8_t*>(kv_mask);
  const uint8_t* qm = static_cast<const uint8_t*>(q_mask);
  if (Lk > 0) {
    const dim3 grid_kv((unsigned)((Lk + TILE - 1) / TILE), (unsigned)(B * H));
    flash_bwd_dkdv_tc_kernel<TD, BLOCK, ANY_COL>
        <<<grid_kv, THREADS, smem_kv, stream>>>(
            qt, kt, vt, gt, lt, dt, km, qm, static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), H, Lq, Lk, inv_temp, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q((unsigned)((Lq + TILE - 1) / TILE), (unsigned)(B * H));
  flash_bwd_dq_tc_kernel<TD, BLOCK, ANY_COL>
      <<<grid_q, THREADS, smem_q, stream>>>(
          qt, kt, vt, gt, lt, dt, km, qm, static_cast<DqType<BLOCK>*>(dq), H,
          Lq, Lk, inv_temp, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_tc_bwd
