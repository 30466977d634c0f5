// The bf16 flash attention forward on the tensor cores at head dims TD = 16,
// 32, 64 and 128, one template over TD (flash_tc.cuh's building blocks), in
// two forms: K2 (flash_attn.cu), and the carry form of the ring's per-hop
// kernel (flash_attn_carry.cu), at TD = 128 and 64 the MID-FC full
// attention in bf16 at d_model 128 and 64 (8 heads of 128 or 64: the
// factory sets d_k = d_v = d_model; a ring at d_k below 64 comes
// zero-padded to 64).
//
// Replaces: csn_tpu/ops/flash.py _flash_forward (Pallas body _fwd_kernel,
// dropout mask _drop_mask) at bf16 heads up to 128; and flash_forward_carry
// (Pallas body _fwd_carry_kernel), which the JAX package reaches through
// ops/attention.py ring_flash_attention, at bf16 heads of 64 and 128.
//
// The body (flash_attn.cu states the function, the dropout identity and the
// bound): one block of 4 warps per (batch*head, 64-query tile), each warp
// owning 16 query rows over the whole head. Q, K and V go global -> shared
// by cp.async into [64][TD + 8] tiles (ldmatrix without bank conflicts), K
// and V double-buffered, so the next live key tile's copy runs under this
// tile's products; one barrier per key tile, the key mask read a tile
// ahead. Q's A fragments are loaded once and kept in registers; S = Q K^T on
// mma.sync m16n8k16 (bf16 in, f32 accumulate); the f32 scores times 1/T
// with log2 e folded in (exp2); the running max and denominator of a row in
// the four lanes that hold it (quad shuffles), the denominator summed per
// lane and reduced once at the end; P rounded to bf16 only as the A
// operand of O += P V, which accumulates in f32 registers (at TD = 128, 64
// of them a lane; the tiles take 87 KB of dynamic shared memory, two
// blocks per SM). Dropout: lanes t and t^1 share one Philox group and swap
// words (flash_tc.cuh drop_words).
//
// The carry form (CARRY) runs the same body over one key block with the
// online-softmax state carried in and out raw, by the contract of
// flash_tf32_fwd.cuh's carry form (csn::Carry, ops/attention.py
// online_block_update's units):
//  * in: m_in (natural units) enters as m_in log2 e, the body's units; l_in
//    on lane t = 0 of the row's quad (0 on the others: the denominator is
//    summed per lane and reduced over the quad at the end, so the rescale
//    applies to each lane's partial sum); acc_in at the lane's C-fragment
//    positions of O, rows q0 + 16 w + g (+ 8), dims 8 n + 2 t (+ 1);
//  * out: m ln 2, the quad-reduced l and O without the division, in f32;
//    no lse (the caller finalizes, ops/flash.py flash_carry_finalize);
//  * pass-through, bit for bit: a query tile with no valid row, a block
//    with no live key tile (copied from the input, not through the log2
//    round trip), and a row whose q_mask is false inside a live tile (the
//    body computes it with whatever q holds, then stores the carry in).
// The dropout words are keyed by absolute (batch*head, row_off + row,
// col_off + column). drop_words assumes a key tile on a multiple of 4
// columns; a ring hop's block may start anywhere (col_off = origin * Lk),
// so ANY_COL draws each lane's two columns of a fragment row with
// csn::dropout_words (flash_tc.cuh keep_bits_any: one or two Philox calls
// a run, up to four times drop_words' one call); flash_attn_carry.cu picks
// it when dropout is on and col_off % 4 != 0. The carry touches device
// memory once before the key loop (the accumulators it fills are O, which
// the loop holds either way) and once in the epilogue; K2's form (CARRY
// false) is the same code with the carry's branches compiled out.
// The kernels and their launcher have internal linkage: both entry points
// (flash_attn.cu, flash_attn_carry.cu) include this file.

#pragma once

#include "flash_tc.cuh"

namespace csn_tc_fwd {
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

// Blocks per SM: four up to TD = 64 (128 registers a thread at TD = 64),
// faster than three with the registers the compiler would take otherwise
// (the carry form at 64 too: 128 registers without spills, against 154 at
// three blocks); three for the carry form's ANY_COL path at 64, which
// spills 364 bytes under 128 registers and takes 168 at three (10.8 ms
// against 14.2 at the ring of one [2, 8, 10000, 64] on an H100); two at
// TD = 128, as many as its shared memory allows. CARRY: the carry form
// (out and lse unused; cy read and written); ANY_COL: the dropout words at
// a column offset that is no multiple of 4
template <int TD, bool CARRY, bool ANY_COL>
__global__ void __launch_bounds__(THREADS,
                                  TD > 64 ? 2 : (CARRY && ANY_COL ? 3 : 4))
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const uint8_t* __restrict__ kv_mask,
                    const uint8_t* __restrict__ q_mask, bf16* __restrict__ out,
                    float* __restrict__ lse, int H, int Lq, int Lk,
                    float inv_temp, uint64_t seed, uint32_t thresh,
                    float inv_keep, int use_drop, int row_off, int col_off,
                    csn::Carry cy) {
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
  const int64_t row_base = (int64_t)bh * Lq;

  int qlive = 0;
  if (tid < TILE) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // padding tile: zeros, or the carry
    if constexpr (CARRY) {
      csn::carry_through<TD, TILE, THREADS>(cy, row_base, q0, Lq, tid);
    } else {
      for (int i = tid; i < TILE * TD / 2; i += THREADS) {
        const int r = q0 + i / (TD / 2);
        if (r < Lq)
          reinterpret_cast<uint32_t*>(op + (int64_t)r * TD)[i % (TD / 2)] =
              0u;
      }
      if (tid < TILE && q0 + tid < Lq) lp[q0 + tid] = NEG_INF + logf(1e-30f);
    }
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
  const bool any_key = kt < nt;  // else the carry passes through
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
  if (CARRY && any_key)  // the carry in, in the body's units
    carry_in<TD>(cy, row_base, (int)row, Lq, t, m, l, o);

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
      uint32_t kb = 0u;
      if constexpr (!CARRY) {
        kb = keep_bits(seed, (uint32_t)bh, row, (uint32_t)(kt * TILE), thresh,
                       t);
      } else {  // rows and keys at their offsets in the global matrix
        const uint32_t grow = (uint32_t)row_off + row;
        const uint32_t col = (uint32_t)(col_off + kt * TILE);
        if constexpr (ANY_COL) {
          kb = keep_bits_any(seed, (uint32_t)bh, grow, col, thresh, t);
        } else {
          kb = keep_bits(seed, (uint32_t)bh, grow, col, thresh, t);
        }
      }
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
    if constexpr (CARRY) {  // raw, or the carry in where the row passes
      carry_out<TD>(cy, row_base + r,
                    !any_key || !q_mask[(int64_t)b * Lq + r], h, t, m[h],
                    l[h], o);
      continue;
    }
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

// Launches one body on bf16 q, k, v [B, H, L, TD] (16-byte aligned): K2
// (CARRY false: out [B, H, Lq, TD] bf16 and lse [B, H, Lq] f32 written;
// drop.row_off and col_off unused, K2's rows and keys are the whole score
// matrix) or the carry form (cy read and written, f32, acc 16-byte aligned;
// drop.row_off / col_off place the query rows and the keys in the global
// score matrix; ANY_COL when dropout is on and drop.col_off % 4 != 0).
// Returns the first CUDA error; never another kernel. Each entry point
// instantiates only the forms it launches (flash_attn.cu K2,
// flash_attn_carry.cu the carry).
template <int TD, bool CARRY = false, bool ANY_COL = false>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* kv_mask, const void* q_mask, void* out,
                       void* lse, const csn::Carry& cy, int B, int H, int Lq,
                       int Lk, float inv_temp, const csn::Drop& drop,
                       cudaStream_t stream) {
  constexpr int smem = fwd_dyn_smem<TD>();
  if (smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<TD, CARRY, ANY_COL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((Lq + TILE - 1) / TILE), (unsigned)(B * H));
  flash_fwd_tc_kernel<TD, CARRY, ANY_COL><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Lq, Lk, inv_temp, drop.seed, drop.thresh,
      drop.inv_keep, drop.on, drop.row_off, drop.col_off, cy);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_tc_fwd
