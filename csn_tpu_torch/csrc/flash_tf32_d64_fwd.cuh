// Masked flash attention forward (online softmax) in f32 at head dim 64 on
// the tensor cores, in split TF32 (3xTF32), from the building blocks of
// flash_tf32.cuh, in two forms: K2 (flash_attn.cu dispatches f32, D = 64
// here, and every f32 head dim below 64, which its wrapper zero-pads to
// 64), and the carry form of the ring's per-hop kernel
// (flash_attn_carry.cu, f32 at D = 64: the MID-FC full attention at
// d_model 64, 8 heads of 64, and any ring at d_k below 64, zero-padded).
//
// Replaces: csn_tpu/ops/flash.py _flash_forward (Pallas body _fwd_kernel,
// dropout mask _drop_mask) at the HRNet heads with f32 activations
// (d_model 256 in 4 heads of 64, `--compute_dtype float32`, the JAX
// package's choice off the TPU): K2 of the SSA and CSA calls of the
// HRNetSimCSN eval request and train step; and flash_forward_carry (Pallas
// body _fwd_carry_kernel), which the JAX package reaches through
// ops/attention.py ring_flash_attention, at f32 heads of 64.
//
// Same function as flash_attn.cu states: online softmax over the key tiles,
// masked keys at NEG_INF (p = 0), the denominator floored at 1e-30, lse
// written in f32, dropout on the numerator only with the mask entry of
// csn::dropout_bits keyed by absolute (batch*head, query row, key column),
// query tiles with no valid query (written as zeros) and key tiles with no
// valid key skipped, cp.async zero-filling rows past L. 1/T multiplies the
// f32 scores, with log2 e folded in so the softmax runs on exp2.
//
// What bounds it on the H100: products, two 64-long ones per (query, key)
// pair, each as three TF32 products; the per-entry work (exp2, the running
// max, the Philox mask: one Philox call per 4 entries) is a larger share
// of the time than at D = 256, since it does not shrink with D.
//
// Design. The FlashAttention-2 shape of the bf16 body (flash_attn.cu): one
// block of 4 warps per (batch*head, 64-query tile), each warp owning 16
// query rows over the whole head, so no partial S crosses warps (the D = 256
// body splits D over the warps of a strip and exchanges S through shared
// memory; at D = 64 a warp's O is 32 registers). Q, K and V tiles are
// [64][64] f32, swizzled as flash_tf32.cuh's tiles (columns of row r XOR
// ((r ^ r >> 1) & 3) << 3: the 8-byte A / K loads and the 4-byte V loads
// both hit 32 banks), copied by cp.async; K and V double-buffered, so the
// next live key tile's copy runs under this tile's products (80 KB of
// shared memory: two blocks per SM). Q's A fragments are split once and
// kept in registers (hi and lo, 64 registers a lane; 254 registers a
// thread in all, no spills), and P V runs over the whole head at once:
// of the layouts that tools/flash_d64_designs.cu holds (Q split from the
// Q tile at every key tile, P V by halves of the head) this one was the
// fastest, with the same bits. Per key tile a warp:
//  1. S = Q K^T, 16 rows x 64 keys, in 8 k-steps of 8 dims: each K B
//     fragment (one 8-byte load) split as it loads, three TF32 products
//     into one accumulator, the small ones first;
//  2. the online softmax in registers (quad shuffles for the row max; the
//     denominator summed per lane and reduced once at the end) and the
//     dropout keep bits of its 16 x 64 entries (flash_tc.cuh keep_bits:
//     the m16n8k8 C fragment has the m16n8k16 one's layout; lanes t and t^1
//     share a Philox group);
//  3. O += P V with P straight from registers: with the permuted k order of
//     flash_tf32.cuh a lane's C fragment of S is its A fragment of P for the
//     same 8 keys (c0 = a0, c2 = a1, c1 = a2, c3 = a3). V is the "B rows are
//     keys" operand (two 4-byte loads). The tile's P V is summed from zero
//     on the tensor cores and added to O in f32 (O <- O alpha + P V): the
//     tensor cores' accumulation truncates, and over thousands of keys its
//     error would pass 1e-4 of the sum.
//
// The carry form (CARRY) runs the same body over one key block with the
// online-softmax state carried in and out raw, by the contract of
// flash_tf32_d128_fwd.cuh's carry form (csn::Carry, ops/attention.py
// online_block_update's units): m_in enters as m_in log2 e, l_in on lane
// t = 0 of the row's quad, acc_in at the lane's C-fragment positions of O;
// out go m ln 2, the quad-reduced l and O undivided, no lse; a query tile
// with no valid row, a block with no live key tile and a row whose q_mask
// is false inside a live tile keep the carry bit for bit. The dropout words
// are keyed by absolute (batch*head, row_off + row, col_off + column),
// through keep_bits where the block starts on a multiple of 4 columns and
// keep_bits_any (ANY_COL; flash_tc.cuh) where it does not. K2's form (CARRY
// false) is the same code with the carry's branches compiled out. The
// kernels and their launcher have internal linkage: flash_attn.cu,
// flash_attn_bwd.cu, flash_attn_carry.cu and flash_attn_block_bwd.cu include
// this file.

#pragma once

#include "flash_tf32.cuh"

namespace csn_tf32_d64 {
namespace {

using csn_tc::carry_in;
using csn_tc::carry_out;
using csn_tc::cp_async16;
using csn_tc::cp_async_commit;
using csn_tc::cp_async_wait;
using csn_tc::drop_words;
using csn_tc::exp2_approx;
using csn_tc::find_live;
using csn_tc::keep_bits;
using csn_tc::keep_bits_any;
using csn_tc::LN2;
using csn_tc::LOG2E;
using csn_tc::NEG_INF;
using csn_tc::row_live;
using csn_tc::TILE;   // 64 rows of a query or key tile
using csn_tf32::FragA;
using csn_tf32::FragB;
using csn_tf32::ld2;
using csn_tf32::mma_tf32;
using csn_tf32::split_a;
using csn_tf32::split_b;
using csn::Carry;
using Drop = csn::Drop;

constexpr int D = 64;          // head dim
constexpr int THREADS = 128;   // 4 warps x 16 query rows

// element (r, c) of a swizzled [rows][64] f32 tile
__device__ __forceinline__ int sw(int r, int c) {
  return r * D + (c ^ (((r ^ (r >> 1)) & 3) << 3));
}

// rows r0 .. r0 + ROWS - 1 of a [L, 64] f32 matrix into a swizzled tile;
// rows at or past L are zeros. Every thread of the block takes part.
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int r0, int L, int tid) {
#pragma unroll
  for (int j = 0; j < ROWS * (D / 4) / NTHREADS; ++j) {
    const int i = j * NTHREADS + tid;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = r0 + r < L;
    cp_async16(dst + sw(r, c), src + (int64_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

// The A fragment of rows m0 + g (+ 8), dims 8 ks .. 8 ks + 7 of a swizzled
// tile, split
__device__ __forceinline__ void load_a(FragA& f, const float* tile, int m0,
                                       int ks, int g, int t) {
  split_a(f, ld2(tile + sw(m0 + g, 8 * ks + 2 * t)),
          ld2(tile + sw(m0 + g + 8, 8 * ks + 2 * t)));
}

// B[k][n] = T[n0 + n][8 ks + k] (B's columns are rows of the tile: K for
// S = Q K^T, V for dP = dO V^T), split
__device__ __forceinline__ void load_b_n(FragB& f, const float* tile,
                                         int n0, int ks, int g, int t) {
  split_b(f, ld2(tile + sw(n0 + g, 8 * ks + 2 * t)));
}

// B[k][n] = T[k0 + k][n0 + n] (B's rows are rows of the tile: V for O +=
// P V, K for dQ += dS K, dO and Q for dV and dK), split
__device__ __forceinline__ void load_b_k(FragB& f, const float* tile,
                                         int k0, int n0, int g, int t) {
  csn_tf32::split(tile[sw(k0 + 2 * t, n0 + g)], f.hi[0], f.lo[0]);
  csn_tf32::split(tile[sw(k0 + 2 * t + 1, n0 + g)], f.hi[1], f.lo[1]);
}

// acc[n] += a . b[n] for N output tiles in split TF32: the small products
// (lo . hi, then hi . lo) of every tile first, then hi . hi
template <int N>
__device__ __forceinline__ void mma3_row(float (&acc)[N][4], const FragA& a,
                                         const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], a.hi, b[n].hi);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// acc[16 x 8 N] += A . T^T over the 64 dims, T a swizzled tile whose rows
// n0 .. n0 + 8 N - 1 are the output columns and A's k-step ks comes from
// `a(ks)`: S = Q K^T and dP = dO V^T for N n-tiles of 8 keys
template <int N, typename LoadA>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], LoadA a,
                                        const float* tile, int n0, int g,
                                        int t) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    FragB b[N];
#pragma unroll
    for (int n = 0; n < N; ++n) load_b_n(b[n], tile, n0 + 8 * n, ks, g, t);
    mma3_row(acc, a(ks), b);
  }
}

// The A fragment of P (16 rows x 8 keys) made of C fragment x of the 8
// keys, split: with the permuted k order c0 = a0, c2 = a1, c1 = a2, c3 = a3
__device__ __forceinline__ void c_to_a(FragA& f, const float (&x)[4]) {
  split_a(f, make_float2(x[0], x[1]), make_float2(x[2], x[3]));
}

// The keep bits of N 8-key fragments from column col0 (a multiple of 8)
// for rows `row` and row + 8 (flash_tc.cuh keep_bits over N fragments)
template <int N>
__device__ __forceinline__ uint32_t keep_bits_n(const Drop& drop, uint32_t bh,
                                                uint32_t row, uint32_t col0,
                                                int t) {
  uint32_t bits = 0u;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    uint32_t w[4];
    drop_words(w, drop.seed, bh, row, col0 + 8 * n, t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bits |= (w[e] < drop.thresh ? 1u : 0u) << (4 * n + e);
  }
  return bits;
}

struct FwdSmem {
  float q[TILE * D];
  float k[2][TILE * D];
  float v[2][TILE * D];
  float kval[2][TILE];  // key flags of the tile in each buffer
};

// CARRY: the carry form (out and lse unused; cy read and written); ANY_COL:
// the dropout words at a column offset that is no multiple of 4
template <bool CARRY, bool ANY_COL>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_tf32_d64_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const uint8_t* __restrict__ kv_mask,
                          const uint8_t* __restrict__ q_mask,
                          float* __restrict__ out, float* __restrict__ lse,
                          int H, int Lq, int Lk, float inv_temp, Drop drop,
                          Carry cy) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * TILE;
  const float* qp = q + (int64_t)bh * Lq * D;
  const float* kp = k + (int64_t)bh * Lk * D;
  const float* vp = v + (int64_t)bh * Lk * D;
  float* op = out + (int64_t)bh * Lq * D;
  float* lp = lse + (int64_t)bh * Lq;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;
  const int64_t row_base = (int64_t)bh * Lq;

  int qlive = 0;
  if (tid < TILE) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // padding tile: zeros, or the carry
    if constexpr (CARRY) {
      csn::carry_through<D, TILE, THREADS>(cy, row_base, q0, Lq, tid);
    } else {
      for (int i = tid; i < TILE * D / 4; i += THREADS) {
        const int r = q0 + i / (D / 4);
        if (r < Lq)
          reinterpret_cast<float4*>(op + (int64_t)r * D)[i % (D / 4)] =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (tid < TILE && q0 + tid < Lq) lp[q0 + tid] = NEG_INF + logf(1e-30f);
    }
    return;
  }

  // The key-tile loop, as the bf16 body's: one barrier per tile
  // (find_live's), which publishes the tile whose copy this thread waited
  // for and orders every warp's reads of the other buffer before it is
  // refilled; the mask bytes of the tile after next loaded a tile ahead.
  const int nt = (Lk + TILE - 1) / TILE;
  copy_rows<TILE, THREADS>(sm.q, qp, q0, Lq, tid);
  int live = row_live(km, Lk, 0, tid);
  int kt = find_live(0, nt, live, km, Lk, tid);
  const bool any_key = kt < nt;  // else the carry passes through
  if (kt < nt) {
    if (tid < TILE) sm.kval[0][tid] = live ? 1.f : 0.f;
    copy_rows<TILE, THREADS>(sm.k[0], kp, kt * TILE, Lk, tid);
    copy_rows<TILE, THREADS>(sm.v[0], vp, kt * TILE, Lk, tid);
  }
  cp_async_commit();
  int pre = row_live(km, Lk, kt + 1, tid);
  cp_async_wait<0>();
  __syncthreads();
  const int r0 = warp * 16;  // the warp's rows in the query tile
  FragA qa[D / 8];  // Q's A fragments, split once
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) load_a(qa[ks], sm.q, r0, ks, g, t);

  const float sc = inv_temp * LOG2E;  // scores in log2 units
  const float inv_keep = drop.on ? drop.inv_keep : 1.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
  zero(o);
  const uint32_t row = (uint32_t)(q0 + r0 + g);
  if (CARRY && any_key)  // the carry in, in the body's units
    carry_in<D>(cy, row_base, (int)row, Lq, t, m, l, o);

  for (int buf = 0; kt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) {  // the next live tile's copy runs under this one
      if (tid < TILE) sm.kval[buf ^ 1][tid] = pre ? 1.f : 0.f;
      copy_rows<TILE, THREADS>(sm.k[buf ^ 1], kp, next * TILE, Lk, tid);
      copy_rows<TILE, THREADS>(sm.v[buf ^ 1], vp, next * TILE, Lk, tid);
      cp_async_commit();
    }
    pre = row_live(km, Lk, next + 1, tid);
    const float* ks_t = sm.k[buf];
    const float* vs_t = sm.v[buf];
    const float* kv = sm.kval[buf];

    // 1. S = Q K^T, 16 rows x 64 keys
    float s[8][4];
    zero(s);
    mma_abt<8>(s, [&](int ks) { return qa[ks]; }, ks_t, 0, g, t);

    // 2. the online softmax, and the dropped numerator
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kv[8 * n + 2 * t + (e & 1)] != 0.f;
        s[n][e] = ok ? s[n][e] * sc : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2_approx(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];  // undropped: the denominator
      }
    if (drop.on) {  // numerator only
      uint32_t kb = 0u;
      if constexpr (!CARRY) {
        kb = keep_bits(drop.seed, (uint32_t)bh, row, (uint32_t)(kt * TILE),
                       drop.thresh, t);
      } else {  // rows and keys at their offsets in the global matrix
        const uint32_t grow = (uint32_t)drop.row_off + row;
        const uint32_t col = (uint32_t)(drop.col_off + kt * TILE);
        kb = ANY_COL ? keep_bits_any(drop.seed, (uint32_t)bh, grow, col,
                                     drop.thresh, t)
                     : keep_bits(drop.seed, (uint32_t)bh, grow, col,
                                 drop.thresh, t);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = (kb >> (4 * n + e)) & 1u ? s[n][e] * inv_keep : 0.f;
    }

    // 3. O = O alpha + P V, the tile's P V summed from zero
    float pv[D / 8][4];
    zero(pv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // keys 8 j .. 8 j + 7
      FragA pa;
      c_to_a(pa, s[j]);
      FragB bv[D / 8];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        load_b_k(bv[n], vs_t, 8 * j, 8 * n, g, t);
      mma3_row(pv, pa, bv);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(o[n][e], alpha[e >> 1], pv[n][e]);
    kt = next;
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = (int)row + 8 * h;
    if (r >= Lq) continue;
    if constexpr (CARRY) {  // raw, or the carry in where the row passes
      carry_out<D>(cy, row_base + r,
                   !any_key || !q_mask[(int64_t)b * Lq + r], h, t, m[h],
                   l[h], o);
      continue;
    }
    const float den = fmaxf(l[h], 1e-30f);
    const float inv = 1.f / den;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(op + (int64_t)r * D + 8 * n + 2 * t) =
          make_float2(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    if (t == 0)
      lp[r] = (m[h] <= NEG_INF ? NEG_INF : m[h] * LN2) + logf(den);
  }
}

// Launches one body on f32 q, k, v [B, H, L, 64] (16-byte aligned): K2
// (CARRY false: out [B, H, Lq, 64] and lse [B, H, Lq] f32 written;
// drop.row_off and col_off unused, K2's rows and keys are the whole score
// matrix) or the carry form (cy read and written, acc 16-byte aligned;
// drop.row_off / col_off place the query rows and the keys in the global
// score matrix; ANY_COL when dropout is on and drop.col_off % 4 != 0).
// Returns the first CUDA error; never another kernel. Each entry point
// instantiates only the forms it launches (flash_attn.cu K2,
// flash_attn_carry.cu the carry).
template <bool CARRY = false, bool ANY_COL = false>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* kv_mask, const void* q_mask, void* out,
                       void* lse, const Carry& cy, int B, int H, int Lq,
                       int Lk, float inv_temp, const Drop& drop,
                       cudaStream_t stream) {
  constexpr int smem = (int)sizeof(FwdSmem);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_d64_kernel<CARRY, ANY_COL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lq + TILE - 1) / TILE), (unsigned)(B * H));
  flash_fwd_tf32_d64_kernel<CARRY, ANY_COL><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<float*>(out),
      static_cast<float*>(lse), H, Lq, Lk, inv_temp, drop, cy);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_tf32_d64
