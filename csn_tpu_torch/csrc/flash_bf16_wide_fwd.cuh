// Masked flash attention forward in bf16 at head dim 256 on the tensor
// cores (mma.sync m16n8k16, f32 accumulators), from the building blocks of
// flash_tc.cuh. flash_attn.cu dispatches bf16, D = 256 here; bf16 at D = 128
// runs flash_tc_fwd.cuh's template at TD = 128 (16 rows x 128 dims is 64
// accumulator registers a lane, which the 4-warp layout holds).
//
// Replaces: csn_tpu/ops/flash.py _flash_forward (Pallas body _fwd_kernel,
// dropout mask _drop_mask) at heads of 256 in bf16: the MID-FC heads with
// compute_dtype "bfloat16", and HRNetSimCSN at d_model 256 in one head; in
// its carry form, flash_forward_carry (Pallas body _fwd_carry_kernel) at the
// same heads: the ring's per-hop kernel of the MID-FC full attention in
// bf16 (flash_attn_carry.cu).
//
// Same function as flash_attn.cu states: online softmax over the key tiles,
// masked keys at NEG_INF, the denominator floored at 1e-30, lse in f32,
// dropout on the numerator only with the mask entry of csn::dropout_bits
// keyed by (batch*head, query row, key column), query tiles with no valid
// query (written as zeros) and key tiles with no valid key skipped,
// cp.async zero-filling rows past L. Rounding points as flash_tc.cuh's
// bodies: f32 scores times 1/T (log2 e folded in, exp2), P rounded to bf16
// once, as the A operand of O += P V, O accumulated in f32.
//
// What bounds it on the H100: products, 4 Lq Lk D operations against
// (2 Lq + 2 Lk) D bf16 bytes per (batch, head): at the MID-FC chunk shape
// and the SSA call far above the bytes.
//
// Design: flash_tf32_fwd.cuh's decomposition, in bf16. A block of 8 warps
// owns 64 queries; warp w owns query rows 32 (w % 2) .. + 31 (two 16-row
// m-blocks) and head dims 64 (w / 2) .. + 63, so a lane holds O for 32 rows
// x 64 dims (64 registers; a 16-row warp over all 256 dims would take 128).
// Q's A fragments for the warp's rows and dims stay in registers (32). K
// and V stream in 64-key tiles, double-buffered by cp.async (the next live
// tile's copy runs under this tile's products) into [64][D + 8] bf16 tiles
// read by ldmatrix (a row stride of 33 x 16 bytes: conflict-free). Per key
// tile a warp:
//  1. computes its quarter of S = Q K^T, 32 rows x 64 keys over its 64
//     dims (4 k-steps of 16, 64 mma.sync), and draws the dropout words of
//     keys 16 (w / 2) .. + 15 for its rows (drop_words);
//  2. hands its partial S and keep bits to the other warps of its 32-row
//     strip through shared memory (lane-major slots, one named barrier for
//     the strip) and sums the four quarters in one fixed order (quarter 0
//     first), so that the four warps hold the same S and run the same online
//     softmax on it (quad shuffles for the row max; the denominator summed
//     per lane and reduced once at the end);
//  3. O = O alpha + P V over its 64 dims, P straight from registers (two C
//     fragments of S are the A fragment of a 16-key k-step, flash_tc.cuh
//     c_to_a), V as B by ldmatrix.trans.
// Q lands in the exchange slots' memory, which its A fragments leave before
// the first exchange: K, V (132 KB), the slots (64 KB) and the keep bits
// take 199 KB of shared memory, one block per SM.
//
// The carry form (CARRY, D = 256; flash_attn_carry.cu, the ring's per-hop
// kernel in bf16 at the MID-FC heads) runs the same body over one key block
// with the online-softmax state carried in and out raw, by the contract of
// flash_tf32_fwd.cuh's carry form:
//  * in: m_in (natural units) enters as m_in log2 e, the body's units; l_in
//    on lane t = 0 of the row's quad (0 on the others: the denominator is
//    summed per lane and reduced over the quad at the end, so alpha
//    rescales each lane's partial sum); acc_in at the lane's C-fragment
//    positions of O, rows r0 + 16 i + g (+ 8), dims d0 + 8 n + 2 t (+ 1);
//  * out: m ln 2, the quad-reduced l and O without the division; no lse
//    (the caller finalizes, ops/flash.py flash_carry_finalize);
//  * pass-through, bit for bit: a query tile with no valid row, a block
//    with no live key tile (copied from the input, not through the log2
//    round trip), and a row whose q_mask is false inside a live tile (the
//    body computes it with whatever q holds, then stores the carry in).
// The dropout words are keyed by absolute (batch*head, row_off + row,
// col_off + column), in K2 too (offsets 0 there). drop_words assumes a key
// run that starts on a multiple of 4 columns; a ring hop's block may start
// anywhere (col_off = origin * Lk), so ANY_COL draws them with
// csn::dropout_words (per fragment two runs of two columns a lane, one or
// two Philox calls each: up to four times drop_words' one call);
// flash_attn_carry.cu picks it when dropout is on and col_off % 4 != 0.
// Memory and registers: the carry touches device memory once on the way in
// (before the key loop: the 64 accumulators it fills are the body's O,
// which exist in registers either way) and once on the way out (the
// epilogue's stores, plus a reload of acc_in for the rows that pass
// through); nothing of it lives across the loop but two offsets, so the key
// loop's register demand is K2's. `conv_ab --kernels flash` prints ptxas's
// registers and spills of both forms (flash_attn.cu, flash_attn_carry.cu).
// The kernels and their launcher have internal linkage: both entry points
// (flash_attn.cu, flash_attn_carry.cu) include this file.

#pragma once

#include "flash_tc.cuh"
#include "flash_tf32_fwd.cuh"

namespace csn_tcw {
namespace {

using namespace csn_tc;

constexpr int WQ = 64;                  // queries per block
constexpr int WK = 64;                  // keys per tile
constexpr int WR = 32;                  // rows of a warp: two m-blocks
constexpr int WSTRIPS = WQ / WR;        // 32-row strips
constexpr int WSPLIT = 4;               // warps per strip, one per D / 4
constexpr int WFWD_THREADS = 32 * WSTRIPS * WSPLIT;
constexpr int WNB = WK / 8;             // 8-key n-tiles of a score tile

template <int D>
struct WideFwdSmem {
  bf16 k[2][WK * lds_of(D)];
  bf16 v[2][WK * lds_of(D)];
  union {
    bf16 q[WQ * lds_of(D)];  // the query tile, until its A fragments load
    // per warp, lane-major: its partial S (entry 4 WNB i + 4 n + e of
    // m-block i, n-tile n)
    float part[WSTRIPS * WSPLIT][2 * 4 * WNB][32];
  } x;
  uint32_t keep[WSTRIPS * WSPLIT][2][32];  // keep bits by m-block
  float kval[2][WK];                       // key flags of each buffer
};

static_assert(32 * WSPLIT == 128, "csn_tc::strip_sync meets 4 warps");

using Carry = csn::Carry;
using Drop = csn::Drop;

// CARRY: the carry form (out and lse unused; cy read and written); ANY_COL:
// the dropout words at a column offset that is no multiple of 4
template <int D, bool CARRY, bool ANY_COL>
__global__ void __launch_bounds__(WFWD_THREADS, 1)
flash_fwd_tc_split_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const uint8_t* __restrict__ kv_mask,
                          const uint8_t* __restrict__ q_mask,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int H, int Lq, int Lk, float inv_temp, Drop drop,
                          Carry cy) {
  static_assert(!CARRY || D == csn_tf32::D, "the carry form is built at 256");
  constexpr int LD = lds_of(D);
  constexpr int DW = D / WSPLIT;  // head dims of a warp
  constexpr int KS = DW / 16;     // k-steps of S over them
  constexpr int NO = DW / 8;      // 8-dim n-tiles of the warp's O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WideFwdSmem<D>& sm = *reinterpret_cast<WideFwdSmem<D>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp % WSTRIPS, quarter = warp / WSTRIPS;
  const int r0 = WR * strip;    // the warp's rows in the query tile
  const int d0 = DW * quarter;  // its head dims
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * WQ;
  const bf16* qp = q + (int64_t)bh * Lq * D;
  const bf16* kp = k + (int64_t)bh * Lk * D;
  const bf16* vp = v + (int64_t)bh * Lk * D;
  bf16* op = out + (int64_t)bh * Lq * D;
  float* lp = lse + (int64_t)bh * Lq;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;
  const int64_t row_base = (int64_t)bh * Lq;

  int qlive = 0;
  if (tid < WQ) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // padding tile: zeros, or the carry
    if constexpr (CARRY) {
      csn::carry_through<D, WQ, WFWD_THREADS>(cy, row_base, q0, Lq, tid);
    } else {
      for (int i = tid; i < WQ * D / 2; i += WFWD_THREADS) {
        const int r = q0 + i / (D / 2);
        if (r < Lq)
          reinterpret_cast<uint32_t*>(op + (int64_t)r * D)[i % (D / 2)] = 0u;
      }
      if (tid < WQ && q0 + tid < Lq) lp[q0 + tid] = NEG_INF + logf(1e-30f);
    }
    return;
  }

  // The key-tile loop, as flash_attn.cu's: one block barrier per tile
  // (find_live's), which publishes the tile whose copy every thread waited
  // for and orders every warp's reads of the other buffer and of the
  // exchange slots before they are written again.
  const int nt = (Lk + WK - 1) / WK;
  load_tile<D, WQ>(sm.x.q, qp, q0, Lq, tid, WFWD_THREADS);
  int live = row_live<WK>(km, Lk, 0, tid);
  int kt = find_live<WK>(0, nt, live, km, Lk, tid);
  const bool any_key = kt < nt;  // else the carry passes through
  if (kt < nt) {
    if (tid < WK) sm.kval[0][tid] = live ? 1.f : 0.f;
    load_tile<D, WK>(sm.k[0], kp, kt * WK, Lk, tid, WFWD_THREADS);
    load_tile<D, WK>(sm.v[0], vp, kt * WK, Lk, tid, WFWD_THREADS);
  }
  cp_async_commit();
  int pre = row_live<WK>(km, Lk, kt + 1, tid);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[2][KS][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(qf[i][ks], sm.x.q + (r0 + 16 * i + (lane & 15)) * LD + d0 +
                             ks * 16 + (lane >> 4) * 8);

  const float sc = inv_temp * LOG2E;  // scores in log2 units
  float m[2][2], l[2][2];             // [m-block][row g, g + 8]
  float o[2][NO][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) m[i][h] = NEG_INF, l[i][h] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  }
  if (CARRY && any_key) {  // the carry in, in the body's units
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = q0 + r0 + 16 * i + g + 8 * h;
        if (r >= Lq) continue;
        m[i][h] = cy.m_in[row_base + r] * LOG2E;
        l[i][h] = t == 0 ? cy.l_in[row_base + r] : 0.f;
        const float* ai = cy.acc_in + (row_base + r) * D + d0 + 2 * t;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const float2 a = csn_tf32::ld2(ai + 8 * n);
          o[i][n][2 * h] = a.x;
          o[i][n][2 * h + 1] = a.y;
        }
      }
  }

  for (int buf = 0; kt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live<WK>(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) {  // the next live tile's copy runs under this one
      if (tid < WK) sm.kval[buf ^ 1][tid] = pre ? 1.f : 0.f;
      load_tile<D, WK>(sm.k[buf ^ 1], kp, next * WK, Lk, tid, WFWD_THREADS);
      load_tile<D, WK>(sm.v[buf ^ 1], vp, next * WK, Lk, tid, WFWD_THREADS);
      cp_async_commit();
    }
    pre = row_live<WK>(km, Lk, next + 1, tid);
    const bf16* ks_t = sm.k[buf];
    const bf16* vs_t = sm.v[buf];
    const float* kv = sm.kval[buf];

    // 1. this warp's quarter of S = Q K^T, 32 rows x 64 keys
    float s[2][WNB][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < WNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nb2 = 0; nb2 < WNB / 2; ++nb2) {
        uint32_t bk[4];
        ldsm_x4(bk, ks_t + (nb2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        d0 + ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(s[i][2 * nb2], qf[i][ks], bk[0], bk[1]);
          mma(s[i][2 * nb2 + 1], qf[i][ks], bk[2], bk[3]);
        }
      }
    uint32_t keep[2] = {0u, 0u};
    if (drop.on) {  // keys 16 quarter .. + 15 of the tile, for both m-blocks
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 2 * quarter + j;
          const uint32_t row =
              (uint32_t)(drop.row_off + q0 + r0 + 16 * i + g);
          const uint32_t col = (uint32_t)(drop.col_off + kt * WK + 8 * n);
          uint32_t w[4];
          if (ANY_COL) {  // rows g and g + 8, columns col + 2t, + 1
            uint32_t w0[2], w1[2];
            csn::dropout_words<2>(drop.seed, (uint32_t)bh, row, col + 2 * t,
                                  w0);
            csn::dropout_words<2>(drop.seed, (uint32_t)bh, row + 8u,
                                  col + 2 * t, w1);
            w[0] = w0[0], w[1] = w0[1], w[2] = w1[0], w[3] = w1[1];
          } else {
            drop_words(w, drop.seed, (uint32_t)bh, row, col, t);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            keep[i] |= (w[e] < drop.thresh ? 1u : 0u) << (4 * n + e);
        }
    }

    // 2. the strip's exchange: S summed over the four quarters of D in one
    // order for all four warps, and the keep bits of all 64 keys
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int n = 0; n < WNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm.x.part[warp][4 * WNB * i + 4 * n + e][lane] = s[i][n][e];
      sm.keep[warp][i][lane] = keep[i];
    }
    strip_sync(strip);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      keep[i] = 0xFFFFFFFFu;
      if (drop.on) {
        keep[i] = 0u;
#pragma unroll
        for (int j = 0; j < WSPLIT; ++j)
          keep[i] |= sm.keep[strip + WSTRIPS * j][i][lane];
      }
    }
    float alpha[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < WNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = 0.f;
#pragma unroll
          for (int j = 0; j < WSPLIT; ++j)
            x += sm.x.part[strip + WSTRIPS * j][4 * WNB * i + 4 * n + e][lane];
          const bool ok = kv[8 * n + 2 * t + (e & 1)] != 0.f;
          s[i][n][e] = ok ? x * sc : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[i][n][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[i][h], mx[h]);
        alpha[i][h] = exp2_approx(m[i][h] - m_new);
        m[i][h] = m_new;
        l[i][h] *= alpha[i][h];
      }
#pragma unroll
      for (int n = 0; n < WNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(s[i][n][e] - m[i][e >> 1]);
          l[i][e >> 1] += p;  // undropped: the denominator
          if (drop.on)        // numerator only
            p = (keep[i] >> (4 * n + e)) & 1u ? p * drop.inv_keep : 0.f;
          s[i][n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][n][e] *= alpha[i][e >> 1];
    }

    // 3. O += P V over this warp's dims, P rounded to bf16 as the A operand
#pragma unroll
    for (int ks = 0; ks < WK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) c_to_a(a[i], s[i], ks);
#pragma unroll
      for (int db2 = 0; db2 < NO / 2; ++db2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs_t + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD + d0 + db2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(o[i][2 * db2], a[i], bv[0], bv[1]);
          mma(o[i][2 * db2 + 1], a[i], bv[2], bv[3]);
        }
      }
    }
    kt = next;
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ll = l[i][h];
      ll += __shfl_xor_sync(0xffffffffu, ll, 1);
      ll += __shfl_xor_sync(0xffffffffu, ll, 2);
      const int r = q0 + r0 + 16 * i + g + 8 * h;
      if (r >= Lq) continue;
      if constexpr (CARRY) {  // raw, or the carry in where the row passes
        const int64_t rr = row_base + r;
        float* ao = cy.acc_out + rr * D + d0 + 2 * t;
        const bool through = !any_key || !q_mask[(int64_t)b * Lq + r];
        if (through) {
          const float* ai = cy.acc_in + rr * D + d0 + 2 * t;
#pragma unroll
          for (int n = 0; n < NO; ++n)
            *reinterpret_cast<float2*>(ao + 8 * n) = csn_tf32::ld2(ai + 8 * n);
        } else {
#pragma unroll
          for (int n = 0; n < NO; ++n)
            *reinterpret_cast<float2*>(ao + 8 * n) =
                make_float2(o[i][n][2 * h], o[i][n][2 * h + 1]);
        }
        if (quarter == 0 && t == 0) {
          cy.m_out[rr] = through ? cy.m_in[rr] : m[i][h] * LN2;
          cy.l_out[rr] = through ? cy.l_in[rr] : ll;
        }
        continue;
      }
      const float den = fmaxf(ll, 1e-30f);
      const float inv = 1.f / den;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(op + (int64_t)r * D + d0 + 8 * n +
                                     2 * t) =
            pack(o[i][n][2 * h] * inv, o[i][n][2 * h + 1] * inv);
      if (quarter == 0 && t == 0)
        lp[r] = (m[i][h] <= NEG_INF ? NEG_INF : m[i][h] * LN2) + logf(den);
    }
}

// Launches one body on bf16 q, k, v [B, H, L, D] (16-byte aligned): K2
// (CARRY false: out [B, H, Lq, D] bf16 and lse [B, H, Lq] f32 written;
// drop.col_off a multiple of 4) or, at D = 256, the carry form (cy read and
// written, f32, acc 16-byte aligned; ANY_COL when drop.col_off % 4 != 0).
// drop.row_off / col_off place the query rows and the keys in the global
// score matrix. Returns the first CUDA error; never another kernel. Each
// entry point instantiates only the forms it launches (flash_attn.cu K2,
// flash_attn_carry.cu the carry).
template <int D, bool CARRY = false, bool ANY_COL = false>
cudaError_t launch_fwd_split(const void* q, const void* k, const void* v,
                             const void* kv_mask, const void* q_mask,
                             void* out, void* lse, const Carry& cy, int B,
                             int H, int Lq, int Lk, float inv_temp,
                             const Drop& drop, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(WideFwdSmem<D>);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_split_kernel<D, CARRY, ANY_COL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lq + WQ - 1) / WQ), (unsigned)(B * H));
  flash_fwd_tc_split_kernel<D, CARRY, ANY_COL>
      <<<grid, WFWD_THREADS, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const uint8_t*>(kv_mask),
          static_cast<const uint8_t*>(q_mask), static_cast<bf16*>(out),
          static_cast<float*>(lse), H, Lq, Lk, inv_temp, drop, cy);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_tcw
