// Masked flash attention backward in f32 at head dim 64 on the tensor
// cores, in split TF32 (3xTF32), from the building blocks of flash_tf32.cuh
// and the tiles of flash_tf32_d64_fwd.cuh, in two forms: K2's backward
// (flash_attn_bwd.cu dispatches f32, D = 64 here, and every f32 head dim
// below 64, zero-padded to 64 by its wrapper), and the block form of the
// ring's per-hop backward (flash_attn_block_bwd.cu, f32 at D = 64: the
// MID-FC full attention at d_model 64, 8 heads of 64).
//
// Replaces: csn_tpu/ops/flash.py _flash_backward (Pallas body
// _bwd_fused_kernel) at the HRNet heads with f32 activations (d_model 256
// in 4 heads of 64): the attention backward of the SSA and CSA calls of the
// HRNetSimCSN train step; and flash_block_backward (the same Pallas body on
// one kv block), which the JAX package reaches through the custom VJP of
// ops/attention.py ring_flash_attention, at f32 heads of 64.
//
// Same function and outputs as flash_attn_bwd.cu states: dQ, dK, dV from
// the saved log-sum-exp rows and delta = rowsum(dO o O), the forward's
// dropout mask regenerated entry for entry (csn::dropout_bits through
// flash_tc.cuh drop_words), query tiles with no valid query and key tiles
// with no valid key skipped (dQ = 0, dK = dV = 0 there), masked keys give
// p = 0, 1/T applied to the f32 scores, exp2 with log2 e folded in.
//
// What bounds it on the H100: products. Per (query, key) pair five 64-long
// products in the dK/dV pass and the dQ pass together (S, dP, dV, dK, dQ)
// plus two recomputed (S, dP in the dQ pass), each as three TF32 products,
// and the per-entry work (exp2, the Philox mask) twice.
//
// Design: the two deterministic passes of the bf16 body (flash_attn_bwd.cu),
// no atomics, in split TF32.
//  * dkdv, one block of 4 warps per (batch*head, 64 keys): K and V stay
//    ([64][64] f32 tiles, 32 KB), Q and dO stream in 32-query tiles,
//    double-buffered by cp.async (32 KB), so the next live tile's copy runs
//    under this tile's products; the P and dS tiles take 16 KB: 80 KB of
//    shared memory, two blocks per SM. Per query tile, two barriers:
//     1. warp w computes S = Q K^T and dP = dO V^T for queries 16 (w & 1) ..
//        + 15 and keys 32 (w >> 1) .. + 31 (Q and dO the A operand, K and V
//        the B operand, each fragment split as it loads), then p, m p / keep
//        and dS = p (m dP / keep - delta) in f32 registers, stored to two
//        [32 queries][64 keys] f32 tiles with the swizzle of the Q, K and V
//        tiles: the C fragments' 8-byte stores and the transposed A loads
//        below (4-byte, rows 2t, columns g) both hit 32 banks;
//     2. after a barrier warp w owns keys 16 w .. + 15 over the whole head:
//        dV += (m P / keep)^T dO and dK += dS^T Q, the transposed A operand
//        read off those tiles (ldmatrix.trans moves 16-bit elements only),
//        dO and Q as "B rows are queries" operands. Each query tile's sum
//        starts from zero on the tensor cores and is added to dK and dV in
//        f32: the tensor cores' accumulation truncates, and over thousands
//        of queries its error would pass 1e-4. dK takes 1/T once at the end.
//  * dq, one block of 4 warps per (batch*head, 64 queries): Q and dO stay
//    (32 KB), K and V stream in 64-key tiles, double-buffered (64 KB), 97 KB
//    of shared memory, two blocks per SM. Each warp owns 16 queries,
//    recomputes S and dP (the forward's 16 x 64 products), p and dS in
//    registers, then dQ += dS K with dS straight from registers as the A
//    operand through the permuted k order (as P in the forward), K as the
//    "B rows are keys" operand; each key tile's dQ summed from zero (a half
//    of the head at a time) and added in f32; 1/T at the end.
// dS is recomputed rather than handed from the dkdv pass through an f32
// scratch, as the D = 256 body does: the scratch would be B H Lk Lq x 4
// bytes, 8.1 GB at the HRNet SSA call [16, 4, 5632, 64], whose write and
// read (16 GB) would take about 4.8 ms at 3.35 TB/s; at D = 64 the two
// recomputed products cost a quarter of D = 256's per (query, key) pair.
//
// The block form (BLOCK) runs the same two passes on one key block of a
// ring, given the GLOBAL lse, delta and dO, and returns the block's dK, dV
// and its f32 term of dQ, which the caller adds over the hops
// (ops/attention.py RingFlashAttentionFn). Its dropout words are keyed by
// absolute (batch*head, row_off + row, col_off + column), through
// keep_bits_any (ANY_COL; flash_tc.cuh) where the block starts off a
// multiple of 4 columns. K2's form (BLOCK false) is the same code with the
// offsets compiled out.

#pragma once

#include "flash_tf32_d64_fwd.cuh"

namespace csn_tf32_d64 {
namespace {

constexpr int BQ = 32;  // queries per streamed tile of the dkdv pass
constexpr int NH = D / 16;  // 8-dim n-tiles of half the head

// p, m p / keep and dS of a warp's 16 x 8N score tile, in place: s and dp
// hold S (raw q . k) and dP on entry, m p / keep and dS on exit. kval: the
// flags of the tile's keys; kb: the lane's keep bits (bit 4 n + e for entry
// e of fragment n).
template <int N>
__device__ __forceinline__ void probs_and_ds(float (&s)[N][4],
                                             float (&dp)[N][4],
                                             const float* kval, float sc,
                                             const float (&lse2)[2],
                                             const float (&dl)[2],
                                             const Drop& drop, uint32_t kb,
                                             int t) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = kval[8 * n + 2 * t + (e & 1)] != 0.f
                          ? exp2_approx(s[n][e] * sc - lse2[h])
                          : 0.f;
      float dpd = dp[n][e], pd = p;
      if (drop.on) {
        const bool keep = (kb >> (4 * n + e)) & 1u;
        dpd = keep ? dpd * drop.inv_keep : 0.f;
        pd = keep ? p * drop.inv_keep : 0.f;
      }
      s[n][e] = pd;
      dp[n][e] = p * (dpd - dl[h]);
    }
}

// lse (in log2 units) and delta of rows row and row + 8; 0 past L (those
// rows carry q = dO = 0, so they add nothing)
__device__ __forceinline__ void row_stats(float (&lse2)[2], float (&dl)[2],
                                          const float* lse,
                                          const float* delta, int row,
                                          int L) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row + 8 * h < L;
    lse2[h] = in ? lse[row + 8 * h] * LOG2E : 0.f;
    dl[h] = in ? delta[row + 8 * h] : 0.f;
  }
}

// acc[n0 + n] += part[n] in f32: a tile's sum, taken from zero on the
// tensor cores, into the running one
template <int N, int M>
__device__ __forceinline__ void add_part(float (&acc)[M][4],
                                         const float (&part)[N][4], int n0) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
}

// acc[16 x 64] += A . T over a tile's BQ queries for the 16 keys kw ..
// kw + 15: A[key][query] = at[query][key] off a P or dS tile (4-byte loads,
// split), T the dO or Q tile as the "B rows are queries" operand. Each half
// of the head's sum starts from zero on the tensor cores and is added to acc
// in f32.
__device__ __forceinline__ void accumulate_t(float (&acc)[D / 8][4],
                                             const float* at,
                                             const float* bt, int kw, int g,
                                             int t) {
  FragA a[BQ / 8];
#pragma unroll
  for (int ks = 0; ks < BQ / 8; ++ks) {
    const int q2 = 8 * ks + 2 * t;
    split_a(a[ks], make_float2(at[sw(q2, kw + g)], at[sw(q2 + 1, kw + g)]),
            make_float2(at[sw(q2, kw + g + 8)], at[sw(q2 + 1, kw + g + 8)]));
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float part[NH][4];
    zero(part);
#pragma unroll
    for (int ks = 0; ks < BQ / 8; ++ks) {
      FragB bb[NH];
#pragma unroll
      for (int n = 0; n < NH; ++n)
        load_b_k(bb[n], bt, 8 * ks, 32 * half + 8 * n, g, t);
      mma3_row(part, a[ks], bb);
    }
    add_part(acc, part, NH * half);
  }
}

// The block form's keep bits of N 8-key fragments, query rows `row` (+ 8)
// and keys col0 .. of the launch at (row_off + row, col_off + col0) in the
// global score matrix (keep_bits_n's layout); keep_bits_any where the key
// block starts off a multiple of 4 columns (ANY_COL)
template <int N, bool ANY_COL>
__device__ __forceinline__ uint32_t block_keep_bits(const Drop& drop,
                                                    uint32_t bh, int row,
                                                    int col0, int t) {
  const uint32_t grow = (uint32_t)(drop.row_off + row);
  const uint32_t col = (uint32_t)(drop.col_off + col0);
  return ANY_COL
             ? keep_bits_any<N>(drop.seed, bh, grow, col, drop.thresh, t)
             : keep_bits_n<N>(drop, bh, grow, col, t);
}

// rows row0 + g (+ 8) of a [L, 64] f32 matrix from a warp's accumulator,
// times f
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&x)[D / 8][4],
                                           int row0, int L, float f, int g,
                                           int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= L) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + (int64_t)r * D + 8 * n + 2 * t) =
          make_float2(x[n][2 * h] * f, x[n][2 * h + 1] * f);
  }
}

// rows r0 .. r0 + 63 (those below L) of a [L, 64] f32 matrix set to zero
__device__ __forceinline__ void zero_rows(float* dst, int r0, int L,
                                          int tid) {
  for (int i = tid; i < TILE * D / 4; i += THREADS) {
    const int r = r0 + i / (D / 4);
    if (r < L)
      reinterpret_cast<float4*>(dst + (int64_t)r * D)[i % (D / 4)] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// --- dK, dV: one block per (batch*head, 64 keys) ----------------------------

struct DkdvSmem {
  float k[TILE * D];
  float v[TILE * D];
  float q[2][BQ * D];
  float dout[2][BQ * D];
  float p[BQ * D];   // m p / keep, [query][key], swizzled as the tiles
  float ds[BQ * D];  // dS, the same
  float kval[TILE];
};

// BLOCK: the block form (the rows and keys at drop.row_off / col_off of the
// global score matrix); ANY_COL: its key block starts off a multiple of 4
// columns
template <bool BLOCK, bool ANY_COL>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_tf32_d64_dkdv_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const uint8_t* __restrict__ kv_mask,
                               const uint8_t* __restrict__ q_mask,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int H, int Lq, int Lk, float inv_temp,
                               Drop drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkdvSmem& sm = *reinterpret_cast<DkdvSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int kv0 = blockIdx.x * TILE;
  const float* qp = q + (int64_t)bh * Lq * D;
  const float* dop = dout + (int64_t)bh * Lq * D;
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
    zero_rows(dk + (int64_t)bh * Lk * D, kv0, Lk, tid);
    zero_rows(dv + (int64_t)bh * Lk * D, kv0, Lk, tid);
    return;
  }
  // The query-tile loop: find_live's barrier publishes the Q and dO tile
  // this thread waited for and orders the previous tile's reads of the
  // other buffers and of the P and dS tiles before they are written again;
  // a second barrier publishes P and dS. Mask bytes, lse and delta are
  // loaded a tile ahead.
  const int nt = (Lq + BQ - 1) / BQ;
  copy_rows<TILE, THREADS>(sm.k, k + (int64_t)bh * Lk * D, kv0, Lk, tid);
  copy_rows<TILE, THREADS>(sm.v, v + (int64_t)bh * Lk * D, kv0, Lk, tid);
  int pre = row_live<BQ>(qm, Lq, 0, tid);
  int qt = find_live<BQ>(0, nt, pre, qm, Lq, tid);
  if (qt < nt) {
    copy_rows<BQ, THREADS>(sm.q[0], qp, qt * BQ, Lq, tid);
    copy_rows<BQ, THREADS>(sm.dout[0], dop, qt * BQ, Lq, tid);
  }
  cp_async_commit();
  pre = row_live<BQ>(qm, Lq, qt + 1, tid);
  // phase 1: queries m0 .. m0 + 15 of the tile, keys n0 .. n0 + 31
  const int m0 = 16 * (warp & 1), n0 = 32 * (warp >> 1);
  float lse2[2], dl[2];
  row_stats(lse2, dl, lp, dlp, qt * BQ + m0 + g, Lq);

  const float sc = inv_temp * LOG2E;
  float acc_k[D / 8][4], acc_v[D / 8][4];
  zero(acc_k);
  zero(acc_v);
  for (int buf = 0; qt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live<BQ>(qt + 1, nt, pre, qm, Lq, tid);
    if (next < nt) {
      copy_rows<BQ, THREADS>(sm.q[buf ^ 1], qp, next * BQ, Lq, tid);
      copy_rows<BQ, THREADS>(sm.dout[buf ^ 1], dop, next * BQ, Lq, tid);
      cp_async_commit();
    }
    pre = row_live<BQ>(qm, Lq, next + 1, tid);
    float lse2_n[2], dl_n[2];
    row_stats(lse2_n, dl_n, lp, dlp, next * BQ + m0 + g, Lq);
    const float* qs = sm.q[buf];
    const float* gs = sm.dout[buf];

    // 1. S and dP of this warp's 16 queries x 32 keys, then P and dS
    const int row = qt * BQ + m0 + g;
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mma_abt<4>(s, [&](int ks) {
      FragA a;
      load_a(a, qs, m0, ks, g, t);
      return a;
    }, sm.k, n0, g, t);
    mma_abt<4>(dp, [&](int ks) {
      FragA a;
      load_a(a, gs, m0, ks, g, t);
      return a;
    }, sm.v, n0, g, t);
    uint32_t kb = 0u;
    if (drop.on) {
      if constexpr (!BLOCK)
        kb = keep_bits_n<4>(drop, (uint32_t)bh, (uint32_t)row,
                            (uint32_t)(kv0 + n0), t);
      else
        kb = block_keep_bits<4, ANY_COL>(drop, (uint32_t)bh, row, kv0 + n0,
                                         t);
    }
    probs_and_ds(s, dp, sm.kval + n0, sc, lse2, dl, drop, kb, t);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int o = sw(m0 + g + 8 * h, n0 + 8 * n + 2 * t);
        *reinterpret_cast<float2*>(sm.p + o) =
            make_float2(s[n][2 * h], s[n][2 * h + 1]);
        *reinterpret_cast<float2*>(sm.ds + o) =
            make_float2(dp[n][2 * h], dp[n][2 * h + 1]);
      }
    __syncthreads();

    // 2. this warp's 16 keys: dV += (m P / keep)^T dO, dK += dS^T Q, over
    // the tile's 32 queries
    accumulate_t(acc_v, sm.p, gs, 16 * warp, g, t);
    accumulate_t(acc_k, sm.ds, qs, 16 * warp, g, t);
    qt = next;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse2[h] = lse2_n[h];
      dl[h] = dl_n[h];
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  const int r0 = kv0 + 16 * warp;
  store_rows(dk + (int64_t)bh * Lk * D, acc_k, r0, Lk, inv_temp, g, t);
  store_rows(dv + (int64_t)bh * Lk * D, acc_v, r0, Lk, 1.f, g, t);
}

// --- dQ: one block per (batch*head, 64 queries) -----------------------------

struct DqSmem {
  float q[TILE * D];
  float dout[TILE * D];
  float k[2][TILE * D];
  float v[2][TILE * D];
  float kval[2][TILE];
};

template <bool BLOCK, bool ANY_COL>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_tf32_d64_dq_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const uint8_t* __restrict__ kv_mask,
                             const uint8_t* __restrict__ q_mask,
                             float* __restrict__ dq, int H, int Lq, int Lk,
                             float inv_temp, Drop drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * TILE;
  const float* kp = k + (int64_t)bh * Lk * D;
  const float* vp = v + (int64_t)bh * Lk * D;
  float* dqp = dq + (int64_t)bh * Lq * D;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;

  int qlive = 0;
  if (tid < TILE) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // no valid query: dQ = 0
    zero_rows(dqp, q0, Lq, tid);
    return;
  }
  const int nt = (Lk + TILE - 1) / TILE;
  copy_rows<TILE, THREADS>(sm.q, q + (int64_t)bh * Lq * D, q0, Lq, tid);
  copy_rows<TILE, THREADS>(sm.dout, dout + (int64_t)bh * Lq * D, q0, Lq,
                           tid);
  int live = row_live(km, Lk, 0, tid);
  int kt = find_live(0, nt, live, km, Lk, tid);
  if (kt < nt) {
    if (tid < TILE) sm.kval[0][tid] = live ? 1.f : 0.f;
    copy_rows<TILE, THREADS>(sm.k[0], kp, kt * TILE, Lk, tid);
    copy_rows<TILE, THREADS>(sm.v[0], vp, kt * TILE, Lk, tid);
  }
  cp_async_commit();
  int pre = row_live(km, Lk, kt + 1, tid);
  const int m0 = 16 * warp;
  const int row = q0 + m0 + g;
  float lse2[2], dl[2];
  row_stats(lse2, dl, lse + (int64_t)bh * Lq, delta + (int64_t)bh * Lq, row,
            Lq);

  const float sc = inv_temp * LOG2E;
  float acc[D / 8][4];
  zero(acc);
  for (int buf = 0; kt < nt; buf ^= 1) {  // the forward's key loop
    cp_async_wait<0>();
    const int next = find_live(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) {
      if (tid < TILE) sm.kval[buf ^ 1][tid] = pre ? 1.f : 0.f;
      copy_rows<TILE, THREADS>(sm.k[buf ^ 1], kp, next * TILE, Lk, tid);
      copy_rows<TILE, THREADS>(sm.v[buf ^ 1], vp, next * TILE, Lk, tid);
      cp_async_commit();
    }
    pre = row_live(km, Lk, next + 1, tid);
    const float* ks_t = sm.k[buf];

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt<8>(s, [&](int ks) {
      FragA a;
      load_a(a, sm.q, m0, ks, g, t);
      return a;
    }, ks_t, 0, g, t);
    mma_abt<8>(dp, [&](int ks) {
      FragA a;
      load_a(a, sm.dout, m0, ks, g, t);
      return a;
    }, sm.v[buf], 0, g, t);
    uint32_t kb = 0u;
    if (drop.on) {
      if constexpr (!BLOCK)
        kb = keep_bits(drop.seed, (uint32_t)bh, (uint32_t)row,
                       (uint32_t)(kt * TILE), drop.thresh, t);
      else
        kb = block_keep_bits<8, ANY_COL>(drop, (uint32_t)bh, row,
                                         kt * TILE, t);
    }
    probs_and_ds(s, dp, sm.kval[buf], sc, lse2, dl, drop, kb, t);
    // dQ += dS K, each half of the head's sum over the tile from zero
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float part[NH][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // keys 8 j .. 8 j + 7
        FragA a;
        c_to_a(a, dp[j]);
        FragB bk[NH];
#pragma unroll
        for (int n = 0; n < NH; ++n)
          load_b_k(bk[n], ks_t, 8 * j, 32 * half + 8 * n, g, t);
        mma3_row(part, a, bk);
      }
      add_part(acc, part, NH * half);
    }
    kt = next;
  }
  cp_async_wait<0>();  // no copy outlives the block
  store_rows(dqp, acc, q0 + m0, Lq, inv_temp, g, t);
}

// Both passes on f32 q, k, v, dout [B, H, L, 64] (16-byte aligned), lse and
// delta [B, H, Lq] f32: dq, dk, dv f32. K2 (BLOCK false: drop.row_off and
// col_off unused) or the block form (dq the block's term; drop.row_off /
// col_off place the rows and keys in the global score matrix; ANY_COL when
// dropout is on and drop.col_off % 4 != 0). Returns the first CUDA error;
// never another kernel. Each entry point instantiates only the forms it
// launches (flash_attn_bwd.cu K2, flash_attn_block_bwd.cu the block form).
template <bool BLOCK = false, bool ANY_COL = false>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* kv_mask, const void* q_mask, void* dq,
                       void* dk, void* dv, int B, int H, int Lq, int Lk,
                       float inv_temp, const Drop& drop,
                       cudaStream_t stream) {
  constexpr int smem_kv = (int)sizeof(DkdvSmem);
  constexpr int smem_q = (int)sizeof(DqSmem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_tf32_d64_dkdv_kernel<BLOCK, ANY_COL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_tf32_d64_dq_kernel<BLOCK, ANY_COL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  const uint8_t* km = static_cast<const uint8_t*>(kv_mask);
  const uint8_t* qm = static_cast<const uint8_t*>(q_mask);
  if (Lk > 0) {
    const dim3 grid_kv((unsigned)((Lk + TILE - 1) / TILE), (unsigned)(B * H));
    flash_bwd_tf32_d64_dkdv_kernel<BLOCK, ANY_COL>
        <<<grid_kv, THREADS, smem_kv, stream>>>(
            qt, kt, vt, gt, lt, dt, km, qm, static_cast<float*>(dk),
            static_cast<float*>(dv), H, Lq, Lk, inv_temp, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q((unsigned)((Lq + TILE - 1) / TILE), (unsigned)(B * H));
  flash_bwd_tf32_d64_dq_kernel<BLOCK, ANY_COL>
      <<<grid_q, THREADS, smem_q, stream>>>(
          qt, kt, vt, gt, lt, dt, km, qm, static_cast<float*>(dq), H, Lq, Lk,
          inv_temp, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_tf32_d64
