// Masked flash attention backward in bf16 at head dims 128 and 256 on the
// tensor cores (mma.sync m16n8k16, f32 accumulators), one template over D.
// flash_attn_bwd.cu dispatches bf16, D = 128 and 256 here.
//
// Replaces: csn_tpu/ops/flash.py _flash_backward (Pallas body
// _bwd_fused_kernel) at heads of 128 and 256 in bf16: HRNetSimCSN at
// d_model 256 in 2 heads or 1, the MID-FC heads with compute_dtype
// "bfloat16"; and flash_block_backward (the same Pallas body on one kv
// block), the ring's per-hop backward of the MID-FC full attention in bf16
// at d_model 256 and 128 (flash_attn_block_bwd.cu).
//
// Same function and outputs as flash_attn_bwd.cu states, in its two
// deterministic passes without atomics (dK and dV per key tile, dQ per query
// tile), from the saved log-sum-exp rows and delta = rowsum(dO o O); query
// tiles with no valid query and key tiles with no valid key skipped; the
// dropout mask regenerated entry for entry (csn::dropout_words, keyed by
// absolute (batch*head, query row, key column)). Rounding points as
// flash_tc.cuh's bodies: bf16 operands, f32 scores, p, dP and dS in f32,
// m p / keep and dS rounded to bf16 once, as the operands of dV, dK and dQ,
// every product accumulated in f32; dK and dQ take 1/T once at the end.
//
// What bounds it on the H100: products, five per (query, key) pair and
// head dim (S, dP, dV, dK, dQ). The bytes of q, k, v, dout, dq, dk and dv
// are a few percent of their time. The dS^T scratch is not: written once
// and read once, 4 bytes per live (query, key, head), it is the price of
// the hand-off below over recomputing dS. At the live pairs of the masks
// chip_smoke.py draws, that is about 2.7 GB a call at the HRNet SSA call
// [16, 2, 5632, 128] (0.81 ms at 3.35 TB/s, 9 % of the 9.1 ms backward
// an H100 measured), 1.3 GB at the CSA call [8, 2, 5632, 128] (9 %),
// 1.35 GB at [16, 1, 5632, 256] (5 % of 7.4 ms) and 0.64 GB at the MID-FC
// chunks [80, 8, 500, 256] (5 % of 3.8 ms).
//
// Design: flash_tf32_bwd.cuh's decomposition, in bf16, with its dS^T
// hand-off: the dK/dV pass writes dS^T, rounded to bf16 as dK's operand, to
// a scratch of ceil32(Lk) x ceil32(Lq) bf16 per (batch*head) (1.0 GB at
// [16, 1, 5632, 256], 2.0 GB at [16, 2, 5632, 128], 335 MB at the MID-FC
// chunks [80, 8, 500, 256]), and the dQ pass is a product over it.
// Recomputing S, dP and dS in the dQ pass instead, as the bf16 D <= 64
// bodies do, makes that pass as slow as the dK/dV pass: per tile pair the
// barriers, the exp and the Philox words cost more than the products. The
// dK/dV pass: a block of a warp per 4
// keys, 64 keys at D = 256 and 32 at D = 128 (kv_keys), walks the live
// query tiles of 32, 3 barriers a tile pair (the liveness vote that
// publishes the streamed tiles, and two below). At D = 256, 64 keys stream
// Q and dO from L2 once per 64 keys, not 32, and meet half as many barriers
// per key, which ran faster on an H100 than blocks of 32 keys, at the cost
// of a few spilled registers (128 a thread); at D = 128 they ran slower
// than two 32-key blocks per SM:
//  1. S = Q K^T (the first half of the warps) and dP = dO V^T (the second):
//     a warp owns 32 queries x one 32-key part over one quarter of D
//     (D / 64 k-steps of 16, the A fragments by ldmatrix from [rows][D + 8]
//     bf16 tiles, K or V as B), into an f32 partial tile per (part, quarter)
//     (flash_tf32_bwd.cuh's swizzle); the dropout words of phase 2 (one
//     Philox call a thread: 4 keys of one query) are drawn after the
//     products issue;
//  2. every thread takes one query x 4 keys: S and dP summed over the four
//     quarters in one fixed order, p, m p / keep and dS (flash_tf32_bwd.cuh
//     probs4), rounded to bf16 into [keys][40] tiles;
//  3. a warp owns 32 keys x D / 8 dims of dV += (m P / keep)^T dO and
//     dK += dS^T Q (A off the P and dS tiles by ldmatrix, dO and Q as B by
//     ldmatrix.trans; 16 or 32 registers a lane for each at D = 128 / 256),
//     while 4 threads a key copy the dS tile to the scratch in 16-byte
//     words.
// K and V stay; Q and dO stream, double-buffered by cp.async (the next
// live tile's copy runs under this pair's products): 206 KB of shared
// memory at D = 256 (one block per SM), 88 KB at D = 128 (two).
// The dQ pass: a block of 8 warps per 32 queries walks the live 32-key
// tiles, K and the dS^T tile streamed double-buffered (one barrier a
// tile), a warp owning 32 queries x D / 8 dims of dQ += dS K (dS as A by
// ldmatrix.trans off the [key][query] tile, K as B by ldmatrix.trans).
//
// The block form (flash_attn_block_bwd.cu) runs the same two passes on one
// key block of a ring, given the GLOBAL lse, delta and dO: the dropout words
// are keyed by absolute (batch*head, row_off + row, col_off + column) at any
// alignment (keep4 draws csn::dropout_words<4>), and the dQ pass stores the
// block's term in DQ_T = float, which the caller adds over the hops in f32
// (ops/attention.py RingFlashAttentionFn); dK and dV stay bf16. At the ring
// of one [2, 8, 10000, 256] (and at head dim 128) the bf16 dS^T scratch is 2 * 8 * 10016^2 * 2 B =
// 3.2 GB: written once and read once, 6.4 GB of traffic, about 1.9 ms at
// 3.35 TB/s, beside the products' bound of about 4.1 ms (10 * 2 * 8 *
// 10000^2 * 256 operations at 989 TFLOP/s).

#pragma once

#include "flash_tc.cuh"
#include "flash_tf32_bwd.cuh"

namespace csn_tcw {
namespace {

using namespace csn_tc;
using csn_tf32::DropAt;
using csn_tf32::keep4;
using csn_tf32::probs4;
using csn_tf32::padded;
using csn_tf32::psw;
using Drop = csn::Drop;

constexpr int WB = 32;              // rows of a query tile, of a dq key tile
// keys of a dkdv block, 8 threads each (a warp per 4 keys): 64 at D = 256,
// 32 at D = 128, where a block of 64 keys (one per SM) ran slower than two
// blocks of 32 per SM
template <int D>
__host__ __device__ constexpr int kv_keys() { return D == 256 ? 64 : 32; }
constexpr int WBWD_THREADS = 256;   // dq: 8 warps
constexpr int WPS = WB + 8;         // stride of the bf16 P and dS tiles

template <int D, int KB = kv_keys<D>()>
struct WideBwdSmem {
  bf16 k[KB * lds_of(D)];
  bf16 v[KB * lds_of(D)];
  bf16 q[2][WB * lds_of(D)];
  bf16 dout[2][WB * lds_of(D)];
  // S and dP partials by 32-key part, D quarter
  float part[2][KB / WB][4][WB * WB];
  bf16 p[KB * WPS];   // m p / keep, [key][query]
  bf16 ds[KB * WPS];  // dS, [key][query]
  float kval[KB];
};

template <int D>
struct WideDqSmem {
  bf16 k[2][WB * lds_of(D)];
  bf16 ds[2][WB * WPS];  // dS^T, [key][query]
};

static_assert(WB == csn_tf32::BR, "the dS^T scratch is [B*H][padded(Lk)]"
              "[padded(Lq)], flash_tf32_bwd.cuh's");

// two adjacent outputs a, b at p: one bf16 pair, or (the block form's f32
// dQ term) one float2
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// rows r0 + 16 i + g (+ 8) of a [L, D] matrix of T, dims d0 + 8 n + 2 t
// (+ 1), from a warp's accumulators, times f
template <int D, int NT, typename T>
__device__ __forceinline__ void store_acc(T* dst, const float (&x)[2][NT][4],
                                          int r0, int d0, int L, float f,
                                          int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * i + g + 8 * h;
      if (r >= L) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        store2(dst + (int64_t)r * D + d0 + 8 * n + 2 * t,
               x[i][n][2 * h] * f, x[i][n][2 * h + 1] * f);
    }
}

template <int D, int ROWS, int NTHREADS, typename T>
__device__ __forceinline__ void zero_tile_rows(T* dst, int r0, int L,
                                               int tid) {
  for (int i = tid; i < ROWS * D / 2; i += NTHREADS) {
    const int r = r0 + i / (D / 2);
    if (r < L) store2(dst + (int64_t)r * D + 2 * (i % (D / 2)), 0.f, 0.f);
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&x)[2][NT][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][n][e] = 0.f;
}

// Phases 1 and 2 of one tile pair of the dkdv pass (KB / 4 warps): S (the
// first half of the warps) or dP (the second) of 32 queries x one 32-key
// part over the warp's quarter of D into its partial tile, one barrier,
// then this thread's query `lane` x keys 4 warp .. + 3: m p / keep and dS
// in bf16 into the P and dS tiles. q_t, g_t: the pair's query tiles (Q,
// dO).
template <int D>
__device__ __forceinline__ void scores_and_ds(
    WideBwdSmem<D>& sm, const bf16* q_t, const bf16* g_t, float sc,
    float lse2, float dl, const Drop& drop, DropAt at, int warp, int lane) {
  constexpr int LD = lds_of(D);
  constexpr int DQ = D / 4;  // head dims of a quarter
  const int g = lane >> 2, t = lane & 3;
  constexpr int KB = kv_keys<D>();
  const bool is_dp = warp >= KB / 8;
  const int half = (warp >> 2) & (KB / WB - 1);
  const bf16* a_t = is_dp ? g_t : q_t;
  const bf16* b_t = (is_dp ? sm.v : sm.k) + WB * half * LD;
  const int c0 = (warp & 3) * DQ;
  float acc[2][4][4];
  zero_acc(acc);
#pragma unroll
  for (int ks = 0; ks < DQ / 16; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4(a[i], a_t + (16 * i + (lane & 15)) * LD + c0 + 16 * ks +
                        (lane >> 4) * 8);
#pragma unroll
    for (int nb2 = 0; nb2 < 2; ++nb2) {
      uint32_t b[4];
      ldsm_x4(b, b_t + (16 * nb2 + (lane & 7) + (lane >> 4) * 8) * LD + c0 +
                     16 * ks + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma(acc[i][2 * nb2], a[i], b[0], b[1]);
        mma(acc[i][2 * nb2 + 1], a[i], b[2], b[3]);
      }
    }
  }
  const uint32_t kb = keep4(drop, at);
  float* out = sm.part[is_dp][half][warp & 3];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int r = 16 * i + g;
      *reinterpret_cast<float2*>(out + psw(r, n * 8 + 2 * t)) =
          make_float2(acc[i][n][0], acc[i][n][1]);
      *reinterpret_cast<float2*>(out + psw(r + 8, n * 8 + 2 * t)) =
          make_float2(acc[i][n][2], acc[i][n][3]);
    }
  __syncthreads();
  float pd[4], ds[4];
  const int h2 = warp >> 3;  // keys 4 warp .. + 3 lie in part h2
  probs4(pd, ds, sm.part[0][h2][0], sm.part[1][h2][0], sm.kval + WB * h2,
         lane, warp & 7, sc, lse2, dl, drop, kb);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sm.p[(4 * warp + j) * WPS + lane] = __float2bfloat16(pd[j]);
    sm.ds[(4 * warp + j) * WPS + lane] = __float2bfloat16(ds[j]);
  }
}

// acc[i][n] (rows 16 i + g .., dims d0 + 8 n ..) += A . T over one tile
// pair's 32 reduced rows: A[i] for k-step ks from `load_a`, T a [WB][D + 8]
// tile whose rows are the reduced index, read transposed (the B operand).
template <int D, int NT, typename LoadA>
__device__ __forceinline__ void accumulate(float (&acc)[2][NT][4],
                                           LoadA load_a, const bf16* tile,
                                           int d0, int lane) {
  constexpr int LD = lds_of(D);
#pragma unroll
  for (int ks = 0; ks < WB / 16; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) load_a(a[i], i, ks);
#pragma unroll
    for (int db2 = 0; db2 < NT / 2; ++db2) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       d0 + 16 * db2 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma(acc[i][2 * db2], a[i], b[0], b[1]);
        mma(acc[i][2 * db2 + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// --- dK, dV and dS^T: one block per (batch*head, kv_keys<D>() keys) --------

template <int D>
__global__ void __launch_bounds__(8 * kv_keys<D>(), D == 256 ? 1 : 2)
flash_bwd_tc_split_dkdv_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const uint8_t* __restrict__ kv_mask,
                               const uint8_t* __restrict__ q_mask,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               bf16* __restrict__ ds_t, int H, int Lq, int Lk,
                               float inv_temp, Drop drop) {
  constexpr int NT = D / 64;  // 8-dim n-tiles of a warp's D / 8 dims
  constexpr int KB = kv_keys<D>(), NTHREADS = 8 * KB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WideBwdSmem<D>& sm = *reinterpret_cast<WideBwdSmem<D>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H;
  const int kv0 = blockIdx.x * KB;
  const bf16* qp = q + (int64_t)bh * Lq * D;
  const bf16* dop = dout + (int64_t)bh * Lq * D;
  const float* lp = lse + (int64_t)bh * Lq;
  const float* dlp = delta + (int64_t)bh * Lq;
  const uint8_t* qm = q_mask + (int64_t)b * Lq;
  const int lq_pad = padded(Lq);
  // this thread's 16 bytes of each dS^T tile: key kv0 + tid / 4, queries
  // 8 (tid % 4) .. + 7 of the query tile (threads below 4 KB; the scratch
  // ends at key padded(Lk), past which the keys are padding)
  const int ds_r = tid >> 2, ds_c = (tid & 3) * 8;
  const bool ds_mine = tid < 4 * KB && kv0 + ds_r < padded(Lk);
  bf16* dsp = ds_t + ((int64_t)bh * padded(Lk) + kv0 + ds_r) * lq_pad + ds_c;

  int live = 0;
  if (tid < KB) {
    const int r = kv0 + tid;
    live = r < Lk && kv_mask[(int64_t)b * Lk + r];
    sm.kval[tid] = live ? 1.f : 0.f;
  }
  if (!__syncthreads_or(live)) {  // no valid key: dK = dV = 0
    zero_tile_rows<D, KB, NTHREADS>(dk + (int64_t)bh * Lk * D, kv0, Lk,
                                        tid);
    zero_tile_rows<D, KB, NTHREADS>(dv + (int64_t)bh * Lk * D, kv0, Lk,
                                        tid);
    return;
  }
  // The query-tile loop: find_live's barrier publishes the Q and dO tiles
  // waited for and orders the previous pair's reads of the other buffers
  // and of the P and dS tiles before they are written again.
  const int nt = (Lq + WB - 1) / WB;
  load_tile<D, KB>(sm.k, k + (int64_t)bh * Lk * D, kv0, Lk, tid, NTHREADS);
  load_tile<D, KB>(sm.v, v + (int64_t)bh * Lk * D, kv0, Lk, tid, NTHREADS);
  int pre = row_live<WB>(qm, Lq, 0, tid);
  int qt = find_live<WB>(0, nt, pre, qm, Lq, tid);
  if (qt < nt) {
    load_tile<D, WB>(sm.q[0], qp, qt * WB, Lq, tid, NTHREADS);
    load_tile<D, WB>(sm.dout[0], dop, qt * WB, Lq, tid, NTHREADS);
  }
  cp_async_commit();
  pre = row_live<WB>(qm, Lq, qt + 1, tid);

  // phase 2's query is `lane`; lse and delta are loaded a tile ahead
  int row = qt * WB + lane;
  float lse2 = row < Lq ? lp[row] * LOG2E : 0.f;
  float dl = row < Lq ? dlp[row] : 0.f;
  const float sc = inv_temp * LOG2E;
  // phase 3: keys kb0 .. kb0 + 31 x these dims
  const int kb0 = WB * (warp >> 3), d0 = (warp & 7) * (D / 8);
  float acc_k[2][NT][4], acc_v[2][NT][4];
  zero_acc(acc_k);
  zero_acc(acc_v);
  for (int buf = 0; qt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live<WB>(qt + 1, nt, pre, qm, Lq, tid);
    if (next < nt) {
      load_tile<D, WB>(sm.q[buf ^ 1], qp, next * WB, Lq, tid, NTHREADS);
      load_tile<D, WB>(sm.dout[buf ^ 1], dop, next * WB, Lq, tid, NTHREADS);
      cp_async_commit();
    }
    pre = row_live<WB>(qm, Lq, next + 1, tid);
    const int row_n = next * WB + lane;
    const float lse2_n = row_n < Lq ? lp[row_n] * LOG2E : 0.f;
    const float dl_n = row_n < Lq ? dlp[row_n] : 0.f;

    const DropAt at{(uint32_t)bh, (uint32_t)(drop.row_off + row),
                    (uint32_t)(drop.col_off + kv0 + 4 * warp)};
    scores_and_ds<D>(sm, sm.q[buf], sm.dout[buf], sc, lse2, dl, drop, at,
                     warp, lane);
    __syncthreads();
    if (ds_mine)  // the dS^T tile to the scratch, for the dQ pass
      *reinterpret_cast<uint4*>(dsp + qt * WB) =
          *reinterpret_cast<const uint4*>(sm.ds + ds_r * WPS + ds_c);
    // dV += (m P / keep)^T dO, dK += dS^T Q: A rows are keys, k queries
    accumulate<D, NT>(
        acc_v,
        [&](uint32_t(&a)[4], int i, int ks) {
          ldsm_x4(a, sm.p + (kb0 + 16 * i + (lane & 15)) * WPS + 16 * ks +
                         (lane >> 4) * 8);
        },
        sm.dout[buf], d0, lane);
    accumulate<D, NT>(
        acc_k,
        [&](uint32_t(&a)[4], int i, int ks) {
          ldsm_x4(a, sm.ds + (kb0 + 16 * i + (lane & 15)) * WPS + 16 * ks +
                         (lane >> 4) * 8);
        },
        sm.q[buf], d0, lane);
    qt = next;
    row = row_n;
    lse2 = lse2_n;
    dl = dl_n;
  }
  cp_async_wait<0>();  // no copy outlives the block
  const int g = lane >> 2, t = lane & 3;
  store_acc<D, NT>(dk + (int64_t)bh * Lk * D, acc_k, kv0 + kb0, d0, Lk,
                   inv_temp, g, t);
  store_acc<D, NT>(dv + (int64_t)bh * Lk * D, acc_v, kv0 + kb0, d0, Lk, 1.f,
                   g, t);
}

// --- dQ = dS K / T: one block per (batch*head, 32 queries) ------------------

// One live key tile's operands of the dq pass: the K tile and the dS^T
// tile the dkdv pass wrote (every (live query tile, live key tile) pair)
template <int D>
__device__ __forceinline__ void load_dq_tile(WideDqSmem<D>& sm, int buf,
                                             const bf16* kp, const bf16* dsp,
                                             int kt, int lq_pad, int Lk,
                                             int tid) {
  load_tile<D, WB>(sm.k[buf], kp, kt * WB, Lk, tid, WBWD_THREADS);
  if (tid < 4 * WB) {
    const int r = tid >> 2, c = (tid & 3) * 8;
    cp_async16(sm.ds[buf] + r * WPS + c,
               dsp + (int64_t)(kt * WB + r) * lq_pad + c, true);
  }
}

template <int D, typename DQ_T>
__global__ void __launch_bounds__(WBWD_THREADS, 2)
flash_bwd_tc_split_dq_kernel(const bf16* __restrict__ k,
                             const bf16* __restrict__ ds_t,
                             const uint8_t* __restrict__ kv_mask,
                             const uint8_t* __restrict__ q_mask,
                             DQ_T* __restrict__ dq, int H, int Lq, int Lk,
                             float inv_temp) {
  constexpr int NT = D / 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WideDqSmem<D>& sm = *reinterpret_cast<WideDqSmem<D>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * WB;
  const bf16* kp = k + (int64_t)bh * Lk * D;
  const int lq_pad = padded(Lq);
  const bf16* dsp = ds_t + (int64_t)bh * padded(Lk) * lq_pad + q0;
  DQ_T* dqp = dq + (int64_t)bh * Lq * D;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;

  int qlive = 0;
  if (tid < WB) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // no valid query: dQ = 0
    zero_tile_rows<D, WB, WBWD_THREADS>(dqp, q0, Lq, tid);
    return;
  }
  // the key tiles the dkdv pass did not skip, one barrier a tile
  const int nt = (Lk + WB - 1) / WB;
  int live = row_live<WB>(km, Lk, 0, tid);
  int kt = find_live<WB>(0, nt, live, km, Lk, tid);
  if (kt < nt) load_dq_tile(sm, 0, kp, dsp, kt, lq_pad, Lk, tid);
  cp_async_commit();
  int pre = row_live<WB>(km, Lk, kt + 1, tid);
  const int d0 = warp * (D / 8);  // all 32 queries x these dims
  float acc[2][NT][4];
  zero_acc(acc);
  for (int buf = 0; kt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live<WB>(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) load_dq_tile(sm, buf ^ 1, kp, dsp, next, lq_pad, Lk, tid);
    cp_async_commit();
    pre = row_live<WB>(km, Lk, next + 1, tid);
    // dQ += dS K: A rows are queries, k keys, off the [key][query] tile
    const bf16* dst = sm.ds[buf];
    accumulate<D, NT>(
        acc,
        [&](uint32_t(&a)[4], int i, int ks) {
          ldsm_x4_t(a, dst + (16 * ks + (lane & 7) + (lane >> 4) * 8) * WPS +
                           16 * i + ((lane >> 3) & 1) * 8);
        },
        sm.k[buf], d0, lane);
    kt = next;
  }
  cp_async_wait<0>();  // no copy outlives the block
  store_acc<D, NT>(dqp, acc, q0, d0, Lq, inv_temp, lane >> 2, lane & 3);
}

// Both passes on bf16 q, k, v, dout [B, H, L, D] (16-byte aligned): dk, dv
// bf16, dq in DQ_T (bf16 for K2, float for the ring's block form); ds_t the
// bf16 scratch the dkdv pass hands dS^T to the dq pass through, padded(Lk)
// * padded(Lq) per (batch*head); drop.row_off / col_off place the rows and
// the keys in the global score matrix (0 for K2). Returns the first CUDA
// error; never another kernel. Each entry point instantiates only the forms
// it launches (flash_attn_bwd.cu K2's, flash_attn_block_bwd.cu the block
// form).
template <int D, typename DQ_T = bf16>
cudaError_t launch_bwd_split(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* kv_mask,
                             const void* q_mask, void* dq, void* dk, void* dv,
                             void* ds_t, int B, int H, int Lq, int Lk,
                             float inv_temp, const Drop& drop,
                             cudaStream_t stream) {
  constexpr int smem_kv = (int)sizeof(WideBwdSmem<D>);
  constexpr int smem_q = (int)sizeof(WideDqSmem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_tc_split_dkdv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_tc_split_dq_kernel<D, DQ_T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const bf16* kt = static_cast<const bf16*>(k);
  const uint8_t* km = static_cast<const uint8_t*>(kv_mask);
  const uint8_t* qm = static_cast<const uint8_t*>(q_mask);
  bf16* dsg = static_cast<bf16*>(ds_t);
  if (Lk > 0) {
    constexpr int KB = kv_keys<D>();
    const dim3 grid_kv((unsigned)((Lk + KB - 1) / KB), (unsigned)(B * H));
    flash_bwd_tc_split_dkdv_kernel<D>
        <<<grid_kv, 8 * KB, smem_kv, stream>>>(
            static_cast<const bf16*>(q), kt, static_cast<const bf16*>(v),
            static_cast<const bf16*>(dout), static_cast<const float*>(lse),
            static_cast<const float*>(delta), km, qm, static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), dsg, H, Lq, Lk, inv_temp, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q((unsigned)((Lq + WB - 1) / WB), (unsigned)(B * H));
  flash_bwd_tc_split_dq_kernel<D, DQ_T>
      <<<grid_q, WBWD_THREADS, smem_q, stream>>>(
          kt, dsg, km, qm, static_cast<DQ_T*>(dq), H, Lq, Lk, inv_temp);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_tcw
