// Masked flash attention backward in f32 at head dims 256 and 128 on the
// tensor cores, in split TF32 (3xTF32), from the building blocks of
// flash_tf32.cuh. flash_attn_bwd.cu dispatches f32, D = 256 and D = 128
// here (and every f32 head dim 65-127, zero-padded to 128 by its wrapper),
// and so does flash_attn_block_bwd.cu for one key block of a ring at 256
// and 128.
//
// Replaces: csn_tpu/ops/flash.py _flash_backward (Pallas body
// _bwd_fused_kernel) at the MID-FC heads (8 heads of 256, f32): the
// attention backward of the CrossShapeAt chunk path; and at 128 the HRNet
// heads with f32 activations at d_model 256 in 2 heads: the attention
// backward of the SSA and CSA calls of the train step. Run on one key block
// (flash_block_backward, the same Pallas body on one kv block), the ring's
// per-hop backward of the MID-FC full attention in f32 at d_model 256 and
// 128.
//
// Same function and outputs as flash_attn_bwd.cu states (on one key block,
// as flash_attn_block_bwd.cu states), in two deterministic passes without
// atomics, from the saved log-sum-exp rows and delta = rowsum(dO o O);
// query tiles with no valid query and key tiles with no valid key skipped;
// masked keys give p = 0;
// 1/T applied to the f32 scores, exp2 with log2 e folded in (as
// flash_tc.cuh). Drop carries row_off / col_off and the dQ pass takes a
// DQ_T, so a per-key-block form (the ring's block backward) can launch the
// same passes.
//  * dkdv, one block per (batch*head, 32 keys): S, dP, dS, dV and dK over
//    the query tiles; it also writes dS^T to an f32 scratch of
//    ceil32(Lk) x ceil32(Lq) per (batch*head) (coalesced: a warp's lanes
//    are 32 consecutive queries of one key).
//  * dq, one block per (batch*head, 32 queries): dQ = dS K / T over the key
//    tiles, dS^T read back from the scratch. The wide kernels' dq pass
//    recomputed S and dP (two of seven products, and the exp and dropout
//    words again); reading dS costs 8 bytes a (query, key) pair of device
//    traffic instead. The scratch is O(Lq Lk) per head, as the plain
//    version's score matrix: 671 MB at the MID-FC chunk shape, 4.1 GB at
//    the HRNet SSA call in 2 heads of 128 [16, 2, 5632, 128], whose round
//    trip (8.1 GB) takes about 2.4 ms at 3.35 TB/s; there this dq pass took
//    2.8 ms and one recomputing S, dP and dS (tools/flash_d128_designs.cu)
//    9.5 on an H100.
//
// What bounds it on the H100: products. Per (query, key) pair five D-long
// products (S, dP, dV, dK, dQ), each as three TF32 products: at 494.7
// TFLOP/s dense TF32 the f32-exact rate is a third of that, and mma.sync
// reaches part of the dense rate. The bytes (q, k, v, dout read; dq, dk, dv
// written; the dS^T scratch written and read) are a fraction of the
// products' time at the MID-FC chunk shape and the HRNet SSA call.
//
// A lane's C entries are not its A entries, so S, dP, P and dS go through
// shared memory in f32. The Q, dO, K and V tiles are [32 rows][D]
// (flash_tf32.cuh's swizzle); the partial score tiles are [32][32] f32
// swizzled by (r & 3) << 3; P, dS are [32][40] (a stride of 8 mod 32).
//
// dkdv: blocks of 8 warps, 32 queries x 32 keys per tile pair, four
// barriers a pair (the liveness vote that publishes the tile, and three
// below):
//  1. S = Q K^T (warps 0-3) and dP = dO V^T (warps 4-7): a warp owns all
//     32 x 32 over one quarter of D (16 TF32 splits feed 24 products a
//     k-step, the next k-step's operands loaded meanwhile), into a partial
//     tile per quarter. The next Q and dO tiles are copied two chunks per
//     thread and k-step along the way, and the dropout words (one Philox
//     call per thread: 4 keys of one query) drawn half way, so that neither
//     stalls the products;
//  2. every thread takes one query x 4 keys: S and dP summed over the four
//     quarters, p, m p / keep and dS = p (m dP / keep - delta), written
//     (after a barrier) over the partial tiles and to the dS^T scratch;
//  3. a warp owns 32 keys (D = 256; 16 at 128) x 32 dims of dV += (m P /
//     keep)^T dO and dK += dS^T Q (64 accumulator registers a lane; 32).
// K and V stay (64 KB; 32 at D = 128), Q and dO stream, double-buffered
// (128 KB; 64), the score tiles take 32 KB: 224 KB of shared memory (128),
// one block per SM.
// dq: 8 warps, a warp owns 32 queries (D = 256; 16 at 128) x 32 dims of
// dQ; the K and dS^T tiles stream, double-buffered (73 KB; 41), two blocks
// per SM.
// The kernels and their launcher have internal linkage: both entry points
// (flash_attn_bwd.cu, flash_attn_block_bwd.cu) include this file.

#pragma once

#include "flash_tf32.cuh"

namespace csn_tf32 {
namespace {

constexpr int BR = 32;        // rows of a query or key tile
constexpr int THREADS = 256;  // 8 warps
constexpr int SP = BR + 8;    // stride of the small [32][SP] tiles
constexpr int ST = BR + 4;    // stride of the dS^T tiles of the dq pass

// element (r, c) of a swizzled [BR][BR] partial score tile: the C fragments'
// 8-byte stores and phase 2's 16-byte loads keep their alignment
__device__ __forceinline__ int psw(int r, int c) {
  return r * BR + (c ^ ((r & 3) << 3));
}

// rows r0 .. r0 + BR - 1 of a [L, TD] f32 matrix into a swizzled tile;
// rows at or past L are zeros
template <int TD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int L, int tid) {
#pragma unroll
  for (int i = tid; i < BR * (TD / 4); i += THREADS) {
    const int r = i / (TD / 4), c = (i % (TD / 4)) * 4;
    const bool ok = r0 + r < L;
    cp_async16(dst + sw<TD>(r, c), src + (int64_t)(ok ? r0 + r : 0) * TD + c,
               ok);
  }
}

// A = rows m0 .. m0+15, columns c0 .. c0+7 of a small [32][SP] tile
__device__ __forceinline__ void load_a_small(FragA& f, const float* tile,
                                             int m0, int c0, int g, int t) {
  split_a(f, ld2(tile + (m0 + g) * SP + c0 + 2 * t),
          ld2(tile + (m0 + g + 8) * SP + c0 + 2 * t));
}

// A = rows m0 .. m0+15, columns c0 .. c0+7 of A^T, a [32][ST] tile: A's
// rows are the tile's columns (the dq pass reads dS off dS^T)
__device__ __forceinline__ void load_a_trans(FragA& f, const float* tile,
                                             int m0, int c0, int g, int t) {
  const float* p = tile + (c0 + 2 * t) * ST + m0 + g;
  split_a(f, make_float2(p[0], p[ST]), make_float2(p[8], p[ST + 8]));
}


// The next Q and dO tiles, copied in slices during phase 1 so that the
// copies overlap the products instead of stalling one burst of issue: 4096
// 16-byte chunks at D = 256 (2048 at 128), two per thread and k-step of
// phase 1.
struct Stream {
  float* dst0;
  float* dst1;
  const float* src0;
  const float* src1;
  int r0, L;
};

template <int TD>
__device__ __forceinline__ void stream_part(const Stream& s, int part,
                                            int tid) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = (2 * part + j) * THREADS + tid;
    const bool first = i < BR * (TD / 4);
    const int r = (i / (TD / 4)) % BR, c = (i % (TD / 4)) * 4;
    const bool ok = s.r0 + r < s.L;
    const int64_t o = (int64_t)(ok ? s.r0 + r : 0) * TD + c;
    cp_async16((first ? s.dst0 : s.dst1) + sw<TD>(r, c),
               (first ? s.src0 : s.src1) + o, ok);
  }
}

// Where phase 2's four entries lie in the dropout mask: (batch*head, query
// row, first key column), absolute
struct DropAt {
  uint32_t bh, row, col;
};

// The keep bits of keys col .. col+3 of query row `row` (bit j for key
// col + j): one Philox call, drawn inside phase 1 so that the integer
// arithmetic overlaps the products
__device__ __forceinline__ uint32_t keep4(const Drop& drop, DropAt at) {
  if (!drop.on) return 0xFu;
  uint32_t w[4];
  csn::dropout_words<4>(drop.seed, at.bh, at.row, at.col, w);
  uint32_t kb = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) kb |= (w[j] < drop.thresh ? 1u : 0u) << j;
  return kb;
}

// The raw operands of one k-step of phase 1: A rows 16m + g (+ 8) and B
// rows 8n + g, columns c0 + 2t, c0 + 2t + 1 of swizzled tiles
struct ScoreOps {
  float2 a[2][2];
  float2 b[4];
};

template <int TD>
__device__ __forceinline__ void load_ops(ScoreOps& o, const float* a_t,
                                         const float* b_t, int c0, int g,
                                         int t) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      o.a[m][h] = ld2(a_t + sw<TD>(16 * m + 8 * h + g, c0 + 2 * t));
#pragma unroll
  for (int n = 0; n < 4; ++n)
    o.b[n] = ld2(b_t + sw<TD>(8 * n + g, c0 + 2 * t));
}

// Phase 1: warp w < 4 computes S = Q K^T, w >= 4 dP = dO V^T, for all 32
// queries and 32 keys over dims TD / 4 (w & 3) .. + TD / 4 - 1, into
// quarter w & 3 of part_s or part_dp. The operands of k-step st + 1 are
// loaded while st's products run; the next tile's copies are issued along
// the way (with `load`), and the keep bits of phase 2 (keep4 of `at`)
// drawn half way.
template <int TD>
__device__ __forceinline__ uint32_t scores(float* part_s, float* part_dp,
                                           const float* qa, const float* kb,
                                           const float* ga, const float* vb,
                                           const Stream& nx, bool load,
                                           const Drop& drop, DropAt at,
                                           int warp, int tid, int g, int t) {
  const bool is_dp = warp >= 4;
  const float* a_t = is_dp ? ga : qa;
  const float* b_t = is_dp ? vb : kb;
  const int c0 = (warp & 3) * (TD / 4);
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  uint32_t keep = 0u;
  ScoreOps cur, nxt;
  load_ops<TD>(cur, a_t, b_t, c0, g, t);
#pragma unroll
  for (int st = 0; st < TD / 32; ++st) {
    if (st + 1 < TD / 32)
      load_ops<TD>(nxt, a_t, b_t, c0 + 8 * (st + 1), g, t);
    FragA a[2];
    FragB b[4];
#pragma unroll
    for (int m = 0; m < 2; ++m) split_a(a[m], cur.a[m][0], cur.a[m][1]);
#pragma unroll
    for (int n = 0; n < 4; ++n) split_b(b[n], cur.b[n]);
    if (load) stream_part<TD>(nx, st, tid);
    if (st == TD / 64 - 1) keep = keep4(drop, at);
    mma3(acc, a, b);
    cur = nxt;
  }
  float* out = (is_dp ? part_dp : part_s) + (warp & 3) * BR * BR;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int r = 16 * m + g;
      *reinterpret_cast<float2*>(out + psw(r, n * 8 + 2 * t)) =
          make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(out + psw(r + 8, n * 8 + 2 * t)) =
          make_float2(acc[m][n][2], acc[m][n][3]);
    }
  return keep;
}

// Phase 2 for query q of the tile and keys 4c .. 4c+3: pd = m p / keep and
// ds = p (m dP / keep - delta), with S and dP summed over the four
// quarters; kb = keep4(...).
__device__ __forceinline__ void probs4(float (&pd)[4], float (&ds)[4],
                                       const float* part_s,
                                       const float* part_dp,
                                       const float* kval, int q, int c,
                                       float sc, float lse2, float dl,
                                       const Drop& drop, uint32_t kb) {
  float sv[4] = {0.f, 0.f, 0.f, 0.f}, dv[4] = {0.f, 0.f, 0.f, 0.f};
  const int o = psw(q, 4 * c);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float4 x = *reinterpret_cast<const float4*>(part_s + h * BR * BR + o);
    const float4 y =
        *reinterpret_cast<const float4*>(part_dp + h * BR * BR + o);
    sv[0] += x.x, sv[1] += x.y, sv[2] += x.z, sv[3] += x.w;
    dv[0] += y.x, dv[1] += y.y, dv[2] += y.z, dv[3] += y.w;
  }
  const float inv_keep = drop.on ? drop.inv_keep : 1.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float p =
        kval[4 * c + j] != 0.f ? exp2_approx(sv[j] * sc - lse2) : 0.f;
    const bool keep = (kb >> j) & 1u;
    pd[j] = keep ? p * inv_keep : 0.f;
    ds[j] = p * ((keep ? dv[j] * inv_keep : 0.f) - dl);
  }
}

template <int M>
__device__ __forceinline__ void zero_acc(float (&x)[M][4][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[m][n][e] = 0.f;
}

// acc[m][n] (rows 16m + g .., dims d0 + 8n ..) += A . T over 32 reduced
// rows for M m-blocks: A[m] from `load_a`(m, k-step), T a swizzled [32][TD]
// tile whose 32 rows are the reduced index (phase 3 of dkdv, the dq pass).
// The tile's sum starts from zero on the tensor cores and is added to acc
// in f32: the tensor cores' accumulation does not round to nearest, and
// over the thousands of keys or queries of a long sequence its error would
// pass 1e-4 of the sum.
template <int TD, int M, typename LoadA>
__device__ __forceinline__ void accumulate(float (&acc)[M][4][4],
                                           LoadA load_a, const float* tile,
                                           int d0, int g, int t) {
  float part[M][4][4];
  zero_acc(part);
#pragma unroll
  for (int st = 0; st < BR / 8; ++st) {
    FragA a[M];
    FragB b[4];
#pragma unroll
    for (int m = 0; m < M; ++m) load_a(a[m], m, st);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      load_b_cols<TD>(b[n], tile, st * 8, d0 + n * 8, g, t);
    mma3(part, a, b);
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
}

// rows r0 + 16m + g (+ 8) of a [L, TD] matrix, dims d0 + 8n + 2t (+1),
// times f
template <int TD, int M, typename T>
__device__ __forceinline__ void store_acc(T* dst, const float (&x)[M][4][4],
                                          int r0, int d0, int L, float f,
                                          int g, int t) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * m + g + 8 * h;
      if (r >= L) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        T* p = dst + (int64_t)r * TD + d0 + n * 8 + 2 * t;
        csn::store(x[m][n][2 * h] * f, p);
        csn::store(x[m][n][2 * h + 1] * f, p + 1);
      }
    }
}

template <int TD, typename T>
__device__ __forceinline__ void zero_rows(T* dst, int r0, int L, int tid) {
  for (int i = tid; i < BR * TD; i += THREADS) {
    const int r = r0 + i / TD;
    if (r < L) csn::store(0.f, dst + (int64_t)r * TD + i % TD);
  }
}

// L rounded up to whole tiles: the dS^T scratch is [B*H][padded(Lk)]
// [padded(Lq)] f32
__device__ __forceinline__ int padded(int L) {
  return (L + BR - 1) / BR * BR;
}

// --- dK, dV and dS: one block per (batch*head, 32 keys) ---------------------

// The tile of phase 3 and of the dq pass that warp `warp` owns at head
// dim TD: dims 32 (warp % (TD / 32)) .. + 31 of rows 16 M (warp / (TD /
// 32)) .. + 16 M - 1, M = TD / 128 m-blocks of 16 rows (at 256 all 32
// rows, at 128 half of them)
template <int TD>
__device__ __forceinline__ void warp_tile(int warp, int& row0, int& d0) {
  static_assert(THREADS / 32 / (TD / 32) * 16 * (TD / 128) == BR,
                "the warps cover 32 rows x TD dims");
  if constexpr (TD == D) {
    row0 = 0, d0 = 32 * warp;
  } else {
    row0 = 16 * (TD / 128) * (warp / (TD / 32));
    d0 = 32 * (warp % (TD / 32));
  }
}

template <int TD>
struct DkdvSmem {
  float k[BR * TD];
  float v[BR * TD];
  float q[2][BR * TD];
  float dout[2][BR * TD];
  // S and dP partials by D quarter, [quarter][query][key]; once phase 2 has
  // read them, m p / keep and dS, [key][query], at the front
  float part[2][4][BR * BR];
  float kval[BR];
};

template <int TD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_tf32_dkdv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const uint8_t* __restrict__ kv_mask,
                           const uint8_t* __restrict__ q_mask,
                           float* __restrict__ dk, float* __restrict__ dv,
                           float* __restrict__ ds_t, int H, int Lq, int Lk,
                           float inv_temp, Drop drop) {
  constexpr int M = TD / 128;  // phase 3's m-blocks of a warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkdvSmem<TD>& sm = *reinterpret_cast<DkdvSmem<TD>*>(smem_raw);
  float* pt = sm.part[0][0];  // m p / keep, [key][SP]
  float* dst = pt + BR * SP;  // dS, [key][SP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int kv0 = blockIdx.x * BR;
  const float* qp = q + (int64_t)bh * Lq * TD;
  const float* dop = dout + (int64_t)bh * Lq * TD;
  const float* lp = lse + (int64_t)bh * Lq;
  const float* dlp = delta + (int64_t)bh * Lq;
  const uint8_t* qm = q_mask + (int64_t)b * Lq;
  const int lq_pad = padded(Lq);
  // this thread's 4 rows of the dS^T scratch (keys 4 warp .. 4 warp + 3)
  float* dsp = ds_t + ((int64_t)bh * padded(Lk) + kv0 + 4 * warp) * lq_pad;

  int live = 0;
  if (tid < BR) {
    const int r = kv0 + tid;
    live = r < Lk && kv_mask[(int64_t)b * Lk + r];
    sm.kval[tid] = live ? 1.f : 0.f;
  }
  if (!__syncthreads_or(live)) {  // no valid key: dK = dV = 0
    zero_rows<TD>(dk + (int64_t)bh * Lk * TD, kv0, Lk, tid);
    zero_rows<TD>(dv + (int64_t)bh * Lk * TD, kv0, Lk, tid);
    return;
  }
  // The query-tile loop: find_live's barrier publishes the Q and dO tile
  // waited for and orders the previous tile's reads of the other buffers
  // and of the score tiles before they are written again.
  const int nt = (Lq + BR - 1) / BR;
  load_rows<TD>(sm.k, k + (int64_t)bh * Lk * TD, kv0, Lk, tid);
  load_rows<TD>(sm.v, v + (int64_t)bh * Lk * TD, kv0, Lk, tid);
  int pre = row_live<BR>(qm, Lq, 0, tid);
  int qt = find_live<BR>(0, nt, pre, qm, Lq, tid);
  if (qt < nt) {
    load_rows<TD>(sm.q[0], qp, qt * BR, Lq, tid);
    load_rows<TD>(sm.dout[0], dop, qt * BR, Lq, tid);
  }
  cp_async_commit();
  pre = row_live<BR>(qm, Lq, qt + 1, tid);

  // phase 2's query is `lane`, its keys 4 warp .. 4 warp + 3; lse and
  // delta are loaded a tile ahead
  int row = qt * BR + lane;
  float lse2 = row < Lq ? lp[row] * LOG2E : 0.f;
  float dl = row < Lq ? dlp[row] : 0.f;
  const float sc = inv_temp * LOG2E;
  int k0, d0;  // phase 3: keys k0 .. k0 + 16 M - 1 x dims d0 .. d0 + 31
  warp_tile<TD>(warp, k0, d0);
  float acc_k[M][4][4], acc_v[M][4][4];
  zero_acc(acc_k);
  zero_acc(acc_v);
  for (int buf = 0; qt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live<BR>(qt + 1, nt, pre, qm, Lq, tid);
    pre = row_live<BR>(qm, Lq, next + 1, tid);
    const int row_n = next * BR + lane;
    const float lse2_n = row_n < Lq ? lp[row_n] * LOG2E : 0.f;
    const float dl_n = row_n < Lq ? dlp[row_n] : 0.f;

    const Stream nx{sm.q[buf ^ 1], sm.dout[buf ^ 1], qp, dop, next * BR, Lq};
    const DropAt at{(uint32_t)bh, (uint32_t)(drop.row_off + row),
                    (uint32_t)(drop.col_off + kv0 + 4 * warp)};
    const uint32_t kb =
        scores<TD>(sm.part[0][0], sm.part[1][0], sm.q[buf], sm.k,
                   sm.dout[buf], sm.v, nx, next < nt, drop, at, warp, tid, g,
                   t);
    cp_async_commit();
    __syncthreads();
    float pd[4], ds[4];
    probs4(pd, ds, sm.part[0][0], sm.part[1][0], sm.kval, lane, warp, sc,
           lse2, dl, drop, kb);
    __syncthreads();  // the partials are read: pt and dst may overwrite them
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pt[(4 * warp + j) * SP + lane] = pd[j];
      dst[(4 * warp + j) * SP + lane] = ds[j];
      dsp[(int64_t)j * lq_pad + qt * BR + lane] = ds[j];
    }
    __syncthreads();
    accumulate<TD>(
        acc_v,
        [&](FragA& f, int m, int st) {
          load_a_small(f, pt, k0 + 16 * m, st * 8, g, t);
        },
        sm.dout[buf], d0, g, t);
    accumulate<TD>(
        acc_k,
        [&](FragA& f, int m, int st) {
          load_a_small(f, dst, k0 + 16 * m, st * 8, g, t);
        },
        sm.q[buf], d0, g, t);
    qt = next;
    row = row_n;
    lse2 = lse2_n;
    dl = dl_n;
  }
  cp_async_wait<0>();  // no copy outlives the block
  store_acc<TD>(dk + (int64_t)bh * Lk * TD, acc_k, kv0 + k0, d0, Lk,
                inv_temp, g, t);
  store_acc<TD>(dv + (int64_t)bh * Lk * TD, acc_v, kv0 + k0, d0, Lk, 1.f, g,
                t);
}

// --- dQ = dS K / T: one block per (batch*head, 32 queries) ------------------

template <int TD>
struct DqSmem {
  float k[2][BR * TD];
  float ds_t[2][BR * ST];  // dS^T, [key][query]
};

// One live key tile's operands of the dq pass: the K tile and the dS^T
// tile the dkdv pass wrote (every (live query tile, live key tile) pair)
template <int TD>
__device__ __forceinline__ void load_dq_tile(DqSmem<TD>& sm, int buf,
                                             const float* kp,
                                             const float* dsp, int kt,
                                             int lq_pad, int Lk, int tid) {
  load_rows<TD>(sm.k[buf], kp, kt * BR, Lk, tid);
  const int r = tid / (BR / 4), c = (tid % (BR / 4)) * 4;
  cp_async16(sm.ds_t[buf] + r * ST + c,
             dsp + (int64_t)(kt * BR + r) * lq_pad + c, true);
}

template <int TD, typename DQ_T>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_tf32_dq_kernel(const float* __restrict__ k,
                         const float* __restrict__ ds_t,
                         const uint8_t* __restrict__ kv_mask,
                         const uint8_t* __restrict__ q_mask,
                         DQ_T* __restrict__ dq, int H, int Lq, int Lk,
                         float inv_temp) {
  constexpr int M = TD / 128;  // m-blocks of a warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem<TD>& sm = *reinterpret_cast<DqSmem<TD>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BR;
  const float* kp = k + (int64_t)bh * Lk * TD;
  const int lq_pad = padded(Lq);
  const float* dsp = ds_t + (int64_t)bh * padded(Lk) * lq_pad + q0;
  DQ_T* dqp = dq + (int64_t)bh * Lq * TD;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;

  int qlive = 0;
  if (tid < BR) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // no valid query: dQ = 0
    zero_rows<TD>(dqp, q0, Lq, tid);
    return;
  }
  // the key tiles the dkdv pass did not skip
  const int nt = (Lk + BR - 1) / BR;
  int live = row_live<BR>(km, Lk, 0, tid);
  int kt = find_live<BR>(0, nt, live, km, Lk, tid);
  if (kt < nt) load_dq_tile(sm, 0, kp, dsp, kt, lq_pad, Lk, tid);
  cp_async_commit();
  int pre = row_live<BR>(km, Lk, kt + 1, tid);
  int r0, d0;  // queries r0 .. r0 + 16 M - 1 x dims d0 .. d0 + 31
  warp_tile<TD>(warp, r0, d0);
  float acc[M][4][4];
  zero_acc(acc);
  for (int buf = 0; kt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live<BR>(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) load_dq_tile(sm, buf ^ 1, kp, dsp, next, lq_pad, Lk, tid);
    cp_async_commit();
    pre = row_live<BR>(km, Lk, next + 1, tid);
    const float* dst = sm.ds_t[buf];
    accumulate<TD>(
        acc,
        [&](FragA& f, int m, int st) {
          load_a_trans(f, dst, r0 + 16 * m, st * 8, g, t);
        },
        sm.k[buf], d0, g, t);
    kt = next;
  }
  cp_async_wait<0>();  // no copy outlives the block
  store_acc<TD>(dqp, acc, q0 + r0, d0, Lq, inv_temp, g, t);
}

// Both passes on f32 q, k, v, dout [B, H, L, TD] (16-byte aligned; TD 256
// or 128): dk, dv f32, dq in DQ_T; ds_t the scratch the dkdv pass hands dS
// to the dq pass through, padded(Lk) * padded(Lq) f32 per (batch*head).
// Returns the first CUDA error; never another kernel.
template <typename DQ_T, int TD = D>
cudaError_t launch_bwd_tf32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* kv_mask,
                            const void* q_mask, void* dq, void* dk, void* dv,
                            void* ds_t, int B, int H, int Lq, int Lk,
                            float inv_temp, Drop drop, cudaStream_t stream) {
  constexpr int smem_kv = (int)sizeof(DkdvSmem<TD>);
  constexpr int smem_q = (int)sizeof(DqSmem<TD>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_tf32_dkdv_kernel<TD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_tf32_dq_kernel<TD, DQ_T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const float* kt = static_cast<const float*>(k);
  const uint8_t* km = static_cast<const uint8_t*>(kv_mask);
  const uint8_t* qm = static_cast<const uint8_t*>(q_mask);
  float* dsg = static_cast<float*>(ds_t);
  if (Lk > 0) {
    const dim3 grid_kv((unsigned)((Lk + BR - 1) / BR), (unsigned)(B * H));
    flash_bwd_tf32_dkdv_kernel<TD><<<grid_kv, THREADS, smem_kv, stream>>>(
        static_cast<const float*>(q), kt, static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), km, qm, static_cast<float*>(dk),
        static_cast<float*>(dv), dsg, H, Lq, Lk, inv_temp, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q((unsigned)((Lq + BR - 1) / BR), (unsigned)(B * H));
  flash_bwd_tf32_dq_kernel<TD, DQ_T><<<grid_q, THREADS, smem_q, stream>>>(
      kt, dsg, km, qm, static_cast<DQ_T*>(dq), H, Lq, Lk, inv_temp);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_tf32
