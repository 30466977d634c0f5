// Masked flash attention forward (online softmax) in f32 at head dim 256 on
// the tensor cores, in split TF32 (3xTF32), from the building blocks of
// flash_tf32.cuh. flash_attn.cu dispatches f32, D = 256 here.
//
// Replaces: csn_tpu/ops/flash.py _flash_forward (Pallas body _fwd_kernel,
// dropout mask _drop_mask) at the MID-FC heads (8 heads of 256, f32): K2 of
// the CrossShapeAt chunk path, of the CSA eval request and of get_csa_pred.
//
// Same function as flash_attn.cu states: online softmax over the key tiles,
// masked keys at NEG_INF (p = 0), the denominator floored at 1e-30, lse
// written in f32, dropout on the numerator only with the mask entry of
// csn::dropout_bits keyed by absolute (batch*head, query row, key column),
// query tiles with no valid query (written as zeros) and key tiles with no
// valid key skipped, cp.async zero-filling rows past L. 1/T multiplies the
// f32 scores, with log2 e folded in so the softmax runs on exp2.
//
// What bounds it on the H100: products. Per (query, key) pair two 256-long
// products (S = Q K^T and O += P V), each as three TF32 products; the bytes
// (q, k, v read, out and lse written) are a few percent of their time at
// the MID-FC chunk shape.
//
// Design. Blocks of 8 warps over 64 queries; K and V stream in 32-key tiles,
// double-buffered by cp.async (the next live tile's copy runs under this
// tile's products), Q stays: 225 KB of shared memory, one block per SM.
// Warp w owns query rows 32 (w % 2) .. + 31 (two 16-row m-blocks) and head
// dims 64 (w / 2) .. + 63: the four warps of a 32-row strip split D, so a
// lane holds O for 32 rows x 64 dims (64 registers; a 16-row warp over all
// 256 dims would take 128 and leave too few for the operands in flight),
// and each K or V fragment a warp splits feeds both of its m-blocks. Per key
// tile a warp:
//  1. computes its quarter of S = Q K^T (32 rows x 32 keys over its 64
//     dims) in 8 k-steps of 8 dims: Q's two A fragments (four 8-byte loads)
//     and K's four B fragments (one 8-byte load each) split as they load,
//     the next k-step's operands loaded under the products, the small and
//     the large products in two accumulators; and draws the dropout words
//     of one 8-key block of the tile for its rows (drop_words: lanes t and
//     t^1 share a Philox group);
//  2. hands its partial S and keep bits to the other warps of the strip
//     through shared memory (a lane-major slot per warp, one named barrier
//     for the strip) and sums the four quarters in one fixed order, so that
//     the four warps hold the same S and run the same online softmax on it
//     in registers (quad shuffles for the row max; the denominator summed
//     per lane and reduced once at the end);
//  3. O += P V over its 64 dims with P straight from registers: with the
//     permuted k order a lane's C fragment of S is, entry for entry, its A
//     fragment of P for the same 8 keys (c0 = a0, c2 = a1, c1 = a2,
//     c3 = a3), so P never goes through shared memory. V is the "B rows are
//     keys" operand (two 4-byte loads, conflict-free under the swizzle).
//     Each group of 16 output dims sums the tile's P V from zero on the
//     tensor cores and is added to O in f32 (O <- O alpha + P V, one FFMA):
//     the tensor cores' accumulation does not round to nearest, and over
//     thousands of keys its error would pass 1e-4 of the sum.
// Q is split as its fragments load, once per key tile: keeping Q's hi and lo
// halves in shared memory (128 KB) leaves room only for 16-key K and V
// tiles, and that variant ran slower.
//
// The carry form (CARRY; flash_attn_carry.cu, the ring's per-hop kernel)
// runs the same body over one key block with the online-softmax state
// carried in and out raw (ops/attention.py online_block_update's units):
//  * in: m_in (natural units) enters as m_in log2 e, the body's units;
//    l_in on lane t = 0 of the row's quad (0 on the others: the
//    denominator is summed per lane and reduced over the quad at the end,
//    so the alpha rescale applies to each lane's partial sum); acc_in at
//    the lane's C-fragment positions of O, rows r0 + 16 i + g (+ 8),
//    columns d0 + 8 n + 2 t (+ 1);
//  * out: m ln 2, the quad-reduced l and O without the division; no lse
//    (the caller finalizes, ops/flash.py flash_carry_finalize);
//  * pass-through, bit for bit: a query tile with no valid row, a block
//    with no live key tile (copied from the input, not through the log2
//    round trip), and a row whose q_mask is false inside a live tile (the
//    body computes it with whatever q holds, then stores the carry in).
// The dropout words of drop_words assume a key tile that starts on a
// multiple of 4 columns; a ring hop's block may start anywhere
// (col_off = origin * Lk), so ANY_COL draws them with csn::dropout_words
// (two runs of two columns a lane, one or two Philox calls each);
// flash_attn_carry.cu picks it when dropout is on and col_off % 4 != 0.
// The kernels and their launcher have internal linkage: both entry points
// (flash_attn.cu, flash_attn_carry.cu) include this file.

#pragma once

#include "flash_tf32.cuh"

namespace csn_tf32 {
namespace {

using csn_tc::drop_words;
using csn_tc::LN2;
using csn_tc::NEG_INF;
using csn_tc::strip_sync;

constexpr int FQ = 64;                     // queries per block
constexpr int FK = 32;                     // keys per tile
constexpr int FR = 32;                     // rows of a warp: two m-blocks
constexpr int FSTRIPS = FQ / FR;           // 32-row strips
constexpr int FSPLIT = 4;                  // warps per strip, one per D / 4
constexpr int FWD_THREADS = 32 * FSTRIPS * FSPLIT;
constexpr int FNB = FK / 8;                // 8-key blocks of a tile
constexpr int FD = D / FSPLIT;             // head dims of a warp
constexpr int FDN = FD / 8;                // 8-dim blocks of a warp's O
constexpr int FPV = 2;                     // 8-dim blocks of a P V group

struct FwdSmem {
  float q[FQ * D];
  float k[2][FK * D];
  float v[2][FK * D];
  float kval[2][FK];  // key flags of the tile in each buffer
  // per warp, lane-major: its partial S (32 x 32 over its quarter of D; entry
  // 16 i + 4 n + e of m-block i, key block n) and its keep bits (the same
  // bit order), for the other warps of the strip
  float part[FSTRIPS * FSPLIT][2 * 4 * FNB][32];
  uint32_t keep[FSTRIPS * FSPLIT][32];
};

using Carry = csn::Carry;

// rows r0 .. r0 + ROWS - 1 of a [L, D] f32 matrix into a swizzled tile; rows
// at or past L are zeros
template <int ROWS>
__device__ __forceinline__ void fwd_copy(float* dst, const float* src,
                                         int r0, int L, int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * (D / 4); i += FWD_THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = r0 + r < L;
    cp_async16(dst + sw(r, c), src + (int64_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

// The raw operands of one k-step of S = Q K^T: Q rows r0 + 16 m + g (+ 8)
// and K rows 8n + g, columns c0 + 2t, c0 + 2t + 1
struct QkOps {
  float2 a[2][2];
  float2 b[FNB];
};

__device__ __forceinline__ void load_qk(QkOps& o, const float* qs,
                                        const float* ks, int r0, int c0,
                                        int g, int t) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    o.a[m][0] = ld2(qs + sw(r0 + 16 * m + g, c0 + 2 * t));
    o.a[m][1] = ld2(qs + sw(r0 + 16 * m + g + 8, c0 + 2 * t));
  }
#pragma unroll
  for (int n = 0; n < FNB; ++n) o.b[n] = ld2(ks + sw(8 * n + g, c0 + 2 * t));
}

static_assert(32 * FSPLIT == 128, "csn_tc::strip_sync meets 4 warps");

// CARRY: the carry form (out and lse unused; cy read and written); ANY_COL:
// the dropout words at a column offset that is no multiple of 4
template <bool CARRY, bool ANY_COL>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const uint8_t* __restrict__ kv_mask,
                      const uint8_t* __restrict__ q_mask,
                      float* __restrict__ out, float* __restrict__ lse, int H,
                      int Lq, int Lk, float inv_temp, Drop drop, Carry cy) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp % FSTRIPS, quarter = warp / FSTRIPS;
  const int r0 = FR * strip;  // the warp's rows in the query tile
  const int d0 = FD * quarter;  // its head dims
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * FQ;
  const float* qp = q + (int64_t)bh * Lq * D;
  const float* kp = k + (int64_t)bh * Lk * D;
  const float* vp = v + (int64_t)bh * Lk * D;
  float* op = out + (int64_t)bh * Lq * D;
  float* lp = lse + (int64_t)bh * Lq;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;
  const int64_t row_base = (int64_t)bh * Lq;

  int qlive = 0;
  if (tid < FQ) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // padding tile: zeros, or the carry
    if (CARRY) {
      csn::carry_through<D, FQ, FWD_THREADS>(cy, row_base, q0, Lq, tid);
    } else {
      for (int i = tid; i < FQ * D / 4; i += FWD_THREADS) {
        const int r = q0 + i / (D / 4);
        if (r < Lq)
          reinterpret_cast<float4*>(op + (int64_t)r * D)[i % (D / 4)] =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (tid < FQ && q0 + tid < Lq) lp[q0 + tid] = NEG_INF + logf(1e-30f);
    }
    return;
  }

  // The key-tile loop: one block barrier per tile (find_live's), which
  // publishes the tile whose copy every thread waited for and orders every
  // warp's reads of the other buffer and of the exchange slots before they
  // are written again. The mask bytes of the tile after next are loaded a
  // tile ahead (pre).
  const int nt = (Lk + FK - 1) / FK;
  fwd_copy<FQ>(sm.q, qp, q0, Lq, tid);
  int live = row_live<FK>(km, Lk, 0, tid);
  int kt = find_live<FK>(0, nt, live, km, Lk, tid);
  const bool any_key = kt < nt;  // else the carry passes through
  if (kt < nt) {
    if (tid < FK) sm.kval[0][tid] = live ? 1.f : 0.f;
    fwd_copy<FK>(sm.k[0], kp, kt * FK, Lk, tid);
    fwd_copy<FK>(sm.v[0], vp, kt * FK, Lk, tid);
  }
  cp_async_commit();
  int pre = row_live<FK>(km, Lk, kt + 1, tid);

  const float sc = inv_temp * LOG2E;  // scores in log2 units
  float m[2][2], l[2][2];  // [m-block][row g, g + 8]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) m[i][h] = NEG_INF, l[i][h] = 0.f;
  float o[2][FDN][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < FDN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
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
        for (int n = 0; n < FDN; ++n) {
          const float2 a = ld2(ai + 8 * n);
          o[i][n][2 * h] = a.x;
          o[i][n][2 * h + 1] = a.y;
        }
      }
  }
  const float inv_keep = drop.on ? drop.inv_keep : 1.f;

  for (int buf = 0; kt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live<FK>(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) {  // the next live tile's copy runs under this one
      if (tid < FK) sm.kval[buf ^ 1][tid] = pre ? 1.f : 0.f;
      fwd_copy<FK>(sm.k[buf ^ 1], kp, next * FK, Lk, tid);
      fwd_copy<FK>(sm.v[buf ^ 1], vp, next * FK, Lk, tid);
      cp_async_commit();
    }
    pre = row_live<FK>(km, Lk, next + 1, tid);
    const float* ks = sm.k[buf];
    const float* vs = sm.v[buf];
    const float* kv = sm.kval[buf];

    // 1. this warp's quarter of S = Q K^T, 32 rows x 32 keys
    float ss[2][FNB][4], sb[2][FNB][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < FNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ss[i][n][e] = sb[i][n][e] = 0.f;
    uint32_t keep = 0u;
    QkOps cur, nxt;
    load_qk(cur, sm.q, ks, r0, d0, g, t);
#pragma unroll
    for (int st = 0; st < FD / 8; ++st) {
      if (st + 1 < FD / 8)
        load_qk(nxt, sm.q, ks, r0, d0 + 8 * (st + 1), g, t);
      FragA a[2];
      FragB bk[FNB];
#pragma unroll
      for (int i = 0; i < 2; ++i) split_a(a[i], cur.a[i][0], cur.a[i][1]);
#pragma unroll
      for (int n = 0; n < FNB; ++n) split_b(bk[n], cur.b[n]);
      if (st == FD / 16 && drop.on) {  // keys 8 quarter .. + 7
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t row = drop.row_off + q0 + r0 + 16 * i + g;
          const uint32_t col = drop.col_off + kt * FK + 8 * quarter;
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
            keep |= (w[e] < drop.thresh ? 1u : 0u)
                    << (16 * i + 4 * quarter + e);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) mma3s(ss[i], sb[i], a[i], bk);
      cur = nxt;
    }

    // 2. the strip's exchange: S summed over the four quarters of D in one
    // order for all four warps, and the keep bits of all 32 keys
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < FNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm.part[warp][16 * i + 4 * n + e][lane] = ss[i][n][e] + sb[i][n][e];
    sm.keep[warp][lane] = keep;
    strip_sync(strip);
    keep = 0xFFFFFFFFu;
    if (drop.on) {
      keep = 0u;
#pragma unroll
      for (int j = 0; j < FSPLIT; ++j)
        keep |= sm.keep[strip + FSTRIPS * j][lane];
    }
    FragA pa[2][FNB];
    float alpha[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s[FNB][4];
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < FNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = 0.f;
#pragma unroll
          for (int j = 0; j < FSPLIT; ++j)
            x += sm.part[strip + FSTRIPS * j][16 * i + 4 * n + e][lane];
          const bool ok = kv[8 * n + 2 * t + (e & 1)] != 0.f;
          s[n][e] = ok ? x * sc : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
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
      for (int n = 0; n < FNB; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = s[n][e] <= NEG_INF ? 0.f
                                    : exp2_approx(s[n][e] - m[i][e >> 1]);
          l[i][e >> 1] += p[e];  // undropped: the denominator
          p[e] = (keep >> (16 * i + 4 * n + e)) & 1u ? p[e] * inv_keep : 0.f;
        }
        // C fragment (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) -> A
        split_a(pa[i][n], make_float2(p[0], p[1]), make_float2(p[2], p[3]));
      }
    }

    // 3. O = O alpha + P V over this warp's dims, each group's P V summed
    // from zero
#pragma unroll
    for (int dg = 0; dg < FDN / FPV; ++dg) {
      float pvs[2][FPV][4], pvb[2][FPV][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < FPV; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pvs[i][n][e] = pvb[i][n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < FNB; ++j) {
        FragB bv[FPV];
#pragma unroll
        for (int n = 0; n < FPV; ++n)
          load_b_cols(bv[n], vs, 8 * j, d0 + 8 * (FPV * dg + n), g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma3s(pvs[i], pvb[i], pa[i][j], bv);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < FPV; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][FPV * dg + n][e] =
                fmaf(o[i][FPV * dg + n][e], alpha[i][e >> 1],
                     pvs[i][n][e] + pvb[i][n][e]);
    }
    kt = next;
  }
  cp_async_wait<0>();  // no copy outlives the block (Q's, if no tile was live)

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ll = l[i][h];
      ll += __shfl_xor_sync(0xffffffffu, ll, 1);
      ll += __shfl_xor_sync(0xffffffffu, ll, 2);
      const int r = q0 + r0 + 16 * i + g + 8 * h;
      if (r >= Lq) continue;
      if (CARRY) {  // raw, or the carry in where the row passes through
        const int64_t rr = row_base + r;
        float* ao = cy.acc_out + rr * D + d0 + 2 * t;
        const bool through = !any_key || !q_mask[(int64_t)b * Lq + r];
        if (through) {
          const float* ai = cy.acc_in + rr * D + d0 + 2 * t;
#pragma unroll
          for (int n = 0; n < FDN; ++n)
            *reinterpret_cast<float2*>(ao + 8 * n) = ld2(ai + 8 * n);
        } else {
#pragma unroll
          for (int n = 0; n < FDN; ++n)
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
      for (int n = 0; n < FDN; ++n)
        *reinterpret_cast<float2*>(op + (int64_t)r * D + d0 + 8 * n + 2 * t) =
            make_float2(o[i][n][2 * h] * inv, o[i][n][2 * h + 1] * inv);
      if (quarter == 0 && t == 0)
        lp[r] = (m[i][h] <= NEG_INF ? NEG_INF : m[i][h] * LN2) + logf(den);
    }
}

// Launches one body: K2 (CARRY false: out [B, H, Lq, 256] f32 and lse
// [B, H, Lq] f32 written; drop.col_off a multiple of 4) or the carry form
// (cy read and written; ANY_COL when drop.col_off % 4 != 0). f32 q, k, v
// (and the carry's acc) 16-byte aligned; drop.row_off / col_off place the
// query rows and the keys in the global score matrix. Returns the first CUDA
// error; never another kernel. Each entry point instantiates only the forms
// it launches (flash_attn.cu K2, flash_attn_carry.cu the carry).
template <bool CARRY, bool ANY_COL>
cudaError_t launch_fwd_tf32(const void* q, const void* k, const void* v,
                            const void* kv_mask, const void* q_mask, void* out,
                            void* lse, const Carry& cy, int B, int H, int Lq,
                            int Lk, float inv_temp, const Drop& drop,
                            cudaStream_t stream) {
  constexpr int smem = (int)sizeof(FwdSmem);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<CARRY, ANY_COL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lq + FQ - 1) / FQ), (unsigned)(B * H));
  flash_fwd_tf32_kernel<CARRY, ANY_COL><<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<float*>(out),
      static_cast<float*>(lse), H, Lq, Lk, inv_temp, drop, cy);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_tf32
