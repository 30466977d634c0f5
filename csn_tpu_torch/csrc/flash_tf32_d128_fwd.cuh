// Masked flash attention forward (online softmax) in f32 at head dim 128 on
// the tensor cores, in split TF32 (3xTF32), from the building blocks of
// flash_tf32.cuh and flash_tf32_d64_fwd.cuh. flash_attn.cu dispatches f32,
// D = 128 here (and every f32 head dim 65-127, which its wrapper zero-pads
// to 128).
//
// Replaces: csn_tpu/ops/flash.py _flash_forward (Pallas body _fwd_kernel,
// dropout mask _drop_mask) at the HRNet heads with f32 activations at
// d_model 256 in 2 heads (`--n_head 2`, or 3 zero-padded to 128; the JAX
// package runs f32 off the TPU): K2 of the SSA and CSA calls of the
// HRNetSimCSN eval request and train step.
//
// Same function as flash_attn.cu states: online softmax over the key tiles,
// masked keys at NEG_INF (p = 0), the denominator floored at 1e-30, lse
// written in f32, dropout on the numerator only with the mask entry of
// csn::dropout_bits keyed by absolute (batch*head, query row, key column),
// query tiles with no valid query (written as zeros) and key tiles with no
// valid key skipped, cp.async zero-filling rows past L. 1/T multiplies the
// f32 scores, with log2 e folded in so the softmax runs on exp2.
//
// What bounds it on the H100: products, two 128-long ones per (query, key)
// pair, each as three TF32 products; the bytes are a few percent of their
// time at the HRNet SSA call.
//
// Design: the layout of the D = 64 body (flash_tf32_d64_fwd.cuh) at twice
// the width. One block of 4 warps per (batch*head, 64-query tile), each
// warp owning 16 query rows over the whole head, so no partial S crosses
// warps. O is 64 registers a lane, which leaves no room for Q's split hi
// and lo halves (128 more): Q's A fragments are loaded and split from the Q
// tile at every k-step of S. K and V stream in 32-key tiles,
// double-buffered by cp.async (the next live tile's copy runs under this
// tile's products): [rows][128] f32 tiles with flash_tf32.cuh's swizzle,
// 96 KB of shared memory, two blocks per SM. Per key tile a warp:
//  1. S = Q K^T, 16 rows x 32 keys, in 16 k-steps of 8 dims, three TF32
//     products into one accumulator (the small ones first);
//  2. the online softmax in registers (quad shuffles for the row max; the
//     denominator summed per lane and reduced once at the end) and the
//     dropout keep bits of its 16 x 32 entries (keep_bits_n: lanes t and
//     t^1 share a Philox group);
//  3. O = O alpha + P V with P straight from registers (a lane's C fragment
//     of S is its A fragment of P for the same 8 keys under the permuted k
//     order), V the "B rows are keys" operand, in groups of 4 n-tiles (32
//     dims): each group's P V over the tile is summed from zero on the
//     tensor cores and added to O in f32, since the tensor cores'
//     accumulation truncates.
// Of the layouts that tools/flash_d128_designs.cu holds (P V by 8 n-tiles,
// 64-key tiles, and the D = 256 body of flash_tf32_fwd.cuh at half the
// width, whose warps split D and exchange partial S through shared memory)
// this one was the fastest at the SSA and CSA calls.
//
// The carry form (CARRY; flash_attn_carry.cu, the ring's per-hop kernel in
// f32 at head dim 128: the MID-FC full attention at d_model 128, whose
// factory sets d_k = d_v = d_model) runs the same body over one key block
// with the online-softmax state carried in and out raw, by the contract of
// flash_tf32_fwd.cuh's carry form (csn::Carry, ops/attention.py
// online_block_update's units):
//  * in: m_in (natural units) enters as m_in log2 e, the body's units; l_in
//    on lane t = 0 of the row's quad (0 on the others: the denominator is
//    summed per lane and reduced over the quad at the end, so alpha
//    rescales each lane's partial sum); acc_in at the lane's C-fragment
//    positions of O, rows q0 + 16 w + g (+ 8), dims 8 n + 2 t (+ 1);
//  * out: m ln 2, the quad-reduced l and O without the division; no lse
//    (the caller finalizes, ops/flash.py flash_carry_finalize);
//  * pass-through, bit for bit: a query tile with no valid row, a block
//    with no live key tile (copied from the input, not through the log2
//    round trip), and a row whose q_mask is false inside a live tile (the
//    body computes it with whatever q holds, then stores the carry in).
// The dropout words are keyed by absolute (batch*head, row_off + row,
// col_off + column). keep_bits_n's lane pairs share a Philox group, which
// assumes a key tile on a multiple of 4 columns; a ring hop's block may
// start anywhere (col_off = origin * Lk), so ANY_COL draws each lane's two
// columns of a fragment row with csn::dropout_words (flash_tc.cuh
// keep_bits_any: one or two Philox calls a run, up to four times
// keep_bits_n's); flash_attn_carry.cu picks it when dropout is on and
// col_off % 4 != 0. The carry touches device memory once before the key
// loop (flash_tc.cuh carry_in; the accumulators it fills are O, which the
// loop holds either way) and once in the epilogue (carry_out); K2's form
// (CARRY false) is the same code with the carry's branches compiled out.
// The kernels and their launcher have internal linkage: both entry points
// (flash_attn.cu, flash_attn_carry.cu) include this file.

#pragma once

#include "flash_tf32_d64_fwd.cuh"

namespace csn_tf32_d128 {
namespace {

using csn_tc::carry_in;
using csn_tc::carry_out;
using csn_tc::cp_async16;
using csn_tc::cp_async_commit;
using csn_tc::cp_async_wait;
using csn_tc::exp2_approx;
using csn_tc::find_live;
using csn_tc::keep_bits_any;
using csn_tc::LN2;
using csn_tc::LOG2E;
using csn_tc::NEG_INF;
using csn_tc::row_live;
using csn_tf32::FragA;
using csn_tf32::FragB;
using csn_tf32::ld2;
using csn_tf32::load_b_cols;
using csn_tf32::split_a;
using csn_tf32::split_b;
using csn_tf32::sw;
using csn_tf32_d64::c_to_a;
using csn_tf32_d64::keep_bits_n;
using csn_tf32_d64::mma3_row;
using csn_tf32_d64::zero;
using csn::Carry;
using Drop = csn::Drop;

constexpr int D = 128;        // head dim
constexpr int QT = 64;        // queries per block
constexpr int KT = 32;        // keys per tile
constexpr int PVN = 4;        // 8-dim n-tiles of a P V group
constexpr int THREADS = 128;  // 4 warps x 16 query rows

// rows r0 .. r0 + ROWS - 1 of a [L, 128] f32 matrix into a swizzled tile;
// rows at or past L are zeros
template <int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int r0, int L, int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = r0 + r < L;
    cp_async16(dst + sw<D>(r, c), src + (int64_t)(ok ? r0 + r : 0) * D + c,
               ok);
  }
}

// acc[16 x 8 N] += A . T^T over the 128 dims: A the rows m0 .. m0 + 15 of
// tile `at` (Q), split at every k-step, T's rows 0 .. 8 N - 1 the output
// columns (K)
template <int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], const float* at,
                                        int m0, const float* tile, int g,
                                        int t) {
#pragma unroll 4
  for (int ks = 0; ks < D / 8; ++ks) {
    FragA a;
    split_a(a, ld2(at + sw<D>(m0 + g, 8 * ks + 2 * t)),
            ld2(at + sw<D>(m0 + g + 8, 8 * ks + 2 * t)));
    FragB b[N];
#pragma unroll
    for (int n = 0; n < N; ++n)
      split_b(b[n], ld2(tile + sw<D>(8 * n + g, 8 * ks + 2 * t)));
    mma3_row(acc, a, b);
  }
}

struct FwdSmem {
  float q[QT * D];
  float k[2][KT * D];
  float v[2][KT * D];
  float kval[2][KT];  // key flags of the tile in each buffer
};

// CARRY: the carry form (out and lse unused; cy read and written); ANY_COL:
// the dropout words at a column offset that is no multiple of 4
template <bool CARRY, bool ANY_COL>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_tf32_d128_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const uint8_t* __restrict__ kv_mask,
                           const uint8_t* __restrict__ q_mask,
                           float* __restrict__ out, float* __restrict__ lse,
                           int H, int Lq, int Lk, float inv_temp, Drop drop,
                           Carry cy) {
  constexpr int NB = KT / 8;  // 8-key n-tiles of a key tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * QT;
  const float* kp = k + (int64_t)bh * Lk * D;
  const float* vp = v + (int64_t)bh * Lk * D;
  float* op = out + (int64_t)bh * Lq * D;
  float* lp = lse + (int64_t)bh * Lq;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;
  const int64_t row_base = (int64_t)bh * Lq;

  int qlive = 0;
  if (tid < QT) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // padding tile: zeros, or the carry
    if constexpr (CARRY) {
      csn::carry_through<D, QT, THREADS>(cy, row_base, q0, Lq, tid);
    } else {
      for (int i = tid; i < QT * D / 4; i += THREADS) {
        const int r = q0 + i / (D / 4);
        if (r < Lq)
          reinterpret_cast<float4*>(op + (int64_t)r * D)[i % (D / 4)] =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (tid < QT && q0 + tid < Lq) lp[q0 + tid] = NEG_INF + logf(1e-30f);
    }
    return;
  }

  // The key-tile loop, as the D = 64 body's: one barrier per tile
  // (find_live's), which publishes the tile whose copy this thread waited
  // for (and Q, with the first) and orders every warp's reads of the other
  // buffer before it is refilled; the mask bytes of the tile after next
  // loaded a tile ahead.
  const int nt = (Lk + KT - 1) / KT;
  copy_rows<QT>(sm.q, q + (int64_t)bh * Lq * D, q0, Lq, tid);
  int live = row_live<KT>(km, Lk, 0, tid);
  int kt = find_live<KT>(0, nt, live, km, Lk, tid);
  const bool any_key = kt < nt;  // else the carry passes through
  if (kt < nt) {
    if (tid < KT) sm.kval[0][tid] = live ? 1.f : 0.f;
    copy_rows<KT>(sm.k[0], kp, kt * KT, Lk, tid);
    copy_rows<KT>(sm.v[0], vp, kt * KT, Lk, tid);
  }
  cp_async_commit();
  int pre = row_live<KT>(km, Lk, kt + 1, tid);
  const int r0 = 16 * warp;  // the warp's rows in the query tile
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
    const int next = find_live<KT>(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) {  // the next live tile's copy runs under this one
      if (tid < KT) sm.kval[buf ^ 1][tid] = pre ? 1.f : 0.f;
      copy_rows<KT>(sm.k[buf ^ 1], kp, next * KT, Lk, tid);
      copy_rows<KT>(sm.v[buf ^ 1], vp, next * KT, Lk, tid);
      cp_async_commit();
    }
    pre = row_live<KT>(km, Lk, next + 1, tid);
    const float* kv = sm.kval[buf];

    // 1. S = Q K^T, 16 rows x 32 keys
    float s[NB][4];
    zero(s);
    mma_abt<NB>(s, sm.q, r0, sm.k[buf], g, t);

    // 2. the online softmax, and the dropped numerator
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NB; ++n)
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
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = s[n][e] <= NEG_INF ? 0.f
                                     : exp2_approx(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];  // undropped: the denominator
      }
    if (drop.on) {  // numerator only
      uint32_t kb = 0u;
      if constexpr (!CARRY) {
        kb = keep_bits_n<NB>(drop, (uint32_t)bh, row, (uint32_t)(kt * KT),
                             t);
      } else {  // rows and keys at their offsets in the global matrix
        const uint32_t grow = (uint32_t)drop.row_off + row;
        const uint32_t col = (uint32_t)(drop.col_off + kt * KT);
        if constexpr (ANY_COL) {
          kb = keep_bits_any<NB>(drop.seed, (uint32_t)bh, grow, col,
                                 drop.thresh, t);
        } else {
          kb = keep_bits_n<NB>(drop, (uint32_t)bh, grow, col, t);
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = (kb >> (4 * n + e)) & 1u ? s[n][e] * inv_keep : 0.f;
    }

    // 3. O = O alpha + P V, each group's P V summed from zero
#pragma unroll
    for (int grp = 0; grp < D / 8 / PVN; ++grp) {
      float pv[PVN][4];
      zero(pv);
#pragma unroll
      for (int j = 0; j < NB; ++j) {  // keys 8 j .. 8 j + 7
        FragA pa;
        c_to_a(pa, s[j]);
        FragB bv[PVN];
#pragma unroll
        for (int n = 0; n < PVN; ++n)
          load_b_cols<D>(bv[n], sm.v[buf], 8 * j, 8 * (PVN * grp + n), g, t);
        mma3_row(pv, pa, bv);
      }
#pragma unroll
      for (int n = 0; n < PVN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[PVN * grp + n][e] =
              fmaf(o[PVN * grp + n][e], alpha[e >> 1], pv[n][e]);
    }
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

// Launches one body on f32 q, k, v [B, H, L, 128] (16-byte aligned): K2
// (CARRY false: out [B, H, Lq, 128] and lse [B, H, Lq] f32 written;
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
      flash_fwd_tf32_d128_kernel<CARRY, ANY_COL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lq + QT - 1) / QT), (unsigned)(B * H));
  flash_fwd_tf32_d128_kernel<CARRY, ANY_COL><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<float*>(out),
      static_cast<float*>(lse), H, Lq, Lk, inv_temp, drop, cy);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_tf32_d128
