// The other layouts of the f32 D=128 split-TF32 attention bodies, to be
// timed against the shipped ones by tools/flash_d128_designs.py. Not part
// of the kernel library: the shipped bodies are flash_tf32_d128_fwd.cuh
// (4 warps of 16 rows over the whole head, 32-key tiles, P V by 4 n-tiles)
// and flash_tf32_bwd.cuh at head dim 128 (dS^T handed to the dQ pass
// through an f32 scratch).
//
// flash_fwd_d128_rows_kernel<KT, PVN> is the shipped forward with two
// choices opened: KT-key tiles (32: 96 KB of shared memory, two blocks per
// SM; 64: 160 KB, one) and P V in groups of PVN 8-dim n-tiles.
//
// flash_fwd_d128_split_kernel is the D = 256 body of flash_tf32_fwd.cuh (K2
// only) at half the width: warp w owns 32 query rows (two m-blocks) of
// strip w % 2 and head dims 64 (w / 2) .. + 63, so the two warps of a strip
// exchange their partial S and keep bits through shared memory and sum S
// in one fixed order (dims 0-63 first); Q is split as it loads at every key
// tile; the small and the large TF32 products of S in two accumulators; P V
// by groups of 2 n-tiles summed from zero. 4 warps over 64 queries, 32-key
// tiles, 113 KB of shared memory, two blocks per SM.
//
// flash_bwd_d128_dq_recompute_kernel: the dQ pass of flash_tf32_d64_bwd.cuh
// at twice the width, which recomputes S, dP and dS from Q, K, V and dO
// instead of reading dS^T from a scratch: 4 warps of 16 queries over the
// whole head, Q and dO stay (64 KB), K and V stream in 32-key tiles,
// double-buffered (128 KB in all, one block per SM); dQ += dS K with dS
// straight from registers, each half of the head's sum over the tile from
// zero.
//
// All compute the shipped bodies' function with the same dropout entries;
// their sums run in other orders, so their outputs are compared with the
// shipped ones by value.

#include "flash_tf32_d128_fwd.cuh"
#include "flash_tf32_d64_bwd.cuh"

namespace csn_d128_designs {
namespace {

using csn_tc::cp_async_commit;
using csn_tc::cp_async_wait;
using csn_tc::drop_words;
using csn_tc::exp2_approx;
using csn_tc::find_live;
using csn_tc::LN2;
using csn_tc::LOG2E;
using csn_tc::NEG_INF;
using csn_tc::row_live;
using csn_tf32::FragA;
using csn_tf32::FragB;
using csn_tf32::ld2;
using csn_tf32::load_b_cols;
using csn_tf32::mma3s;
using csn_tf32::split_a;
using csn_tf32::split_b;
using csn_tf32::sw;
using csn_tf32_d128::copy_rows;
using csn_tf32_d128::mma_abt;
using csn_tf32_d128::QT;
using csn_tf32_d128::THREADS;
using csn_tf32_d64::add_part;
using csn_tf32_d64::c_to_a;
using csn_tf32_d64::keep_bits_n;
using csn_tf32_d64::mma3_row;
using csn_tf32_d64::probs_and_ds;
using csn_tf32_d64::row_stats;
using csn_tf32_d64::zero;
using Drop = csn_tf32::Drop;

constexpr int DH = csn_tf32_d128::D;  // head dim

template <int KT>
struct FwdSmem {
  float q[QT * DH];
  float k[2][KT * DH];
  float v[2][KT * DH];
  float kval[2][KT];
};

template <int KT, int PVN>
__global__ void __launch_bounds__(THREADS, KT == 32 ? 2 : 1)
flash_fwd_d128_rows_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const uint8_t* __restrict__ kv_mask,
                           const uint8_t* __restrict__ q_mask,
                           float* __restrict__ out, float* __restrict__ lse,
                           int H, int Lq, int Lk, float inv_temp,
                           Drop drop) {
  constexpr int NB = KT / 8;  // 8-key n-tiles of a key tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<KT>& sm = *reinterpret_cast<FwdSmem<KT>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * QT;
  const float* kp = k + (int64_t)bh * Lk * DH;
  const float* vp = v + (int64_t)bh * Lk * DH;
  float* op = out + (int64_t)bh * Lq * DH;
  float* lp = lse + (int64_t)bh * Lq;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;

  int qlive = 0;
  if (tid < QT) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // padding tile: zeros
    for (int i = tid; i < QT * DH / 4; i += THREADS) {
      const int r = q0 + i / (DH / 4);
      if (r < Lq)
        reinterpret_cast<float4*>(op + (int64_t)r * DH)[i % (DH / 4)] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid < QT && q0 + tid < Lq) lp[q0 + tid] = NEG_INF + logf(1e-30f);
    return;
  }
  const int nt = (Lk + KT - 1) / KT;
  copy_rows<QT>(sm.q, q + (int64_t)bh * Lq * DH, q0, Lq, tid);
  int live = row_live<KT>(km, Lk, 0, tid);
  int kt = find_live<KT>(0, nt, live, km, Lk, tid);
  if (kt < nt) {
    if (tid < KT) sm.kval[0][tid] = live ? 1.f : 0.f;
    copy_rows<KT>(sm.k[0], kp, kt * KT, Lk, tid);
    copy_rows<KT>(sm.v[0], vp, kt * KT, Lk, tid);
  }
  cp_async_commit();
  int pre = row_live<KT>(km, Lk, kt + 1, tid);
  const int r0 = 16 * warp;
  const float sc = inv_temp * LOG2E;
  const float inv_keep = drop.on ? drop.inv_keep : 1.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DH / 8][4];
  zero(o);
  const uint32_t row = (uint32_t)(q0 + r0 + g);

  for (int buf = 0; kt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live<KT>(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) {
      if (tid < KT) sm.kval[buf ^ 1][tid] = pre ? 1.f : 0.f;
      copy_rows<KT>(sm.k[buf ^ 1], kp, next * KT, Lk, tid);
      copy_rows<KT>(sm.v[buf ^ 1], vp, next * KT, Lk, tid);
      cp_async_commit();
    }
    pre = row_live<KT>(km, Lk, next + 1, tid);
    const float* kv = sm.kval[buf];

    float s[NB][4];
    zero(s);
    mma_abt<NB>(s, sm.q, r0, sm.k[buf], g, t);
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
        l[e >> 1] += s[n][e];
      }
    if (drop.on) {
      const uint32_t kb = keep_bits_n<NB>(drop, (uint32_t)bh, row,
                                          (uint32_t)(kt * KT), t);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = (kb >> (4 * n + e)) & 1u ? s[n][e] * inv_keep : 0.f;
    }
#pragma unroll
    for (int grp = 0; grp < DH / 8 / PVN; ++grp) {
      float pv[PVN][4];
      zero(pv);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        FragA pa;
        c_to_a(pa, s[j]);
        FragB bv[PVN];
#pragma unroll
        for (int n = 0; n < PVN; ++n)
          load_b_cols<DH>(bv[n], sm.v[buf], 8 * j, 8 * (PVN * grp + n), g,
                          t);
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
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = (int)row + 8 * h;
    if (r >= Lq) continue;
    const float den = fmaxf(l[h], 1e-30f);
    const float inv = 1.f / den;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(op + (int64_t)r * DH + 8 * n + 2 * t) =
          make_float2(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    if (t == 0)
      lp[r] = (m[h] <= NEG_INF ? NEG_INF : m[h] * LN2) + logf(den);
  }
}

// --- the D = 256 body at half the width --------------------------------------

constexpr int SR = 32;     // rows of a warp: two m-blocks
constexpr int SK = 32;     // keys per tile
constexpr int SNB = SK / 8;
constexpr int SFD = 64;    // head dims of a warp
constexpr int SPV = 2;     // 8-dim n-tiles of a P V group

struct SplitSmem {
  float q[QT * DH];
  float k[2][SK * DH];
  float v[2][SK * DH];
  float kval[2][SK];
  float part[4][2 * 4 * SNB][32];  // per warp, lane-major: partial S
  uint32_t keep[4][32];            // per warp: its keep bits
};

__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_d128_split_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const uint8_t* __restrict__ kv_mask,
                            const uint8_t* __restrict__ q_mask,
                            float* __restrict__ out, float* __restrict__ lse,
                            int H, int Lq, int Lk, float inv_temp,
                            Drop drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SplitSmem& sm = *reinterpret_cast<SplitSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp % 2, half = warp / 2;
  const int r0 = SR * strip, d0 = SFD * half;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * QT;
  const float* kp = k + (int64_t)bh * Lk * DH;
  const float* vp = v + (int64_t)bh * Lk * DH;
  float* op = out + (int64_t)bh * Lq * DH;
  float* lp = lse + (int64_t)bh * Lq;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;

  int qlive = 0;
  if (tid < QT) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // padding tile: zeros
    for (int i = tid; i < QT * DH / 4; i += THREADS) {
      const int r = q0 + i / (DH / 4);
      if (r < Lq)
        reinterpret_cast<float4*>(op + (int64_t)r * DH)[i % (DH / 4)] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid < QT && q0 + tid < Lq) lp[q0 + tid] = NEG_INF + logf(1e-30f);
    return;
  }
  const int nt = (Lk + SK - 1) / SK;
  copy_rows<QT>(sm.q, q + (int64_t)bh * Lq * DH, q0, Lq, tid);
  int live = row_live<SK>(km, Lk, 0, tid);
  int kt = find_live<SK>(0, nt, live, km, Lk, tid);
  if (kt < nt) {
    if (tid < SK) sm.kval[0][tid] = live ? 1.f : 0.f;
    copy_rows<SK>(sm.k[0], kp, kt * SK, Lk, tid);
    copy_rows<SK>(sm.v[0], vp, kt * SK, Lk, tid);
  }
  cp_async_commit();
  int pre = row_live<SK>(km, Lk, kt + 1, tid);
  const float sc = inv_temp * LOG2E;
  const float inv_keep = drop.on ? drop.inv_keep : 1.f;
  float m[2][2], l[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) m[i][h] = NEG_INF, l[i][h] = 0.f;
  float o[2][SFD / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) zero(o[i]);

  for (int buf = 0; kt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live<SK>(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) {
      if (tid < SK) sm.kval[buf ^ 1][tid] = pre ? 1.f : 0.f;
      copy_rows<SK>(sm.k[buf ^ 1], kp, next * SK, Lk, tid);
      copy_rows<SK>(sm.v[buf ^ 1], vp, next * SK, Lk, tid);
      cp_async_commit();
    }
    pre = row_live<SK>(km, Lk, next + 1, tid);
    const float* ks = sm.k[buf];
    const float* vs = sm.v[buf];
    const float* kv = sm.kval[buf];

    // 1. this warp's half of S, and the keep bits of key blocks 2 half, + 1
    float ss[2][SNB][4], sb[2][SNB][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      zero(ss[i]);
      zero(sb[i]);
    }
    uint32_t keep = 0u;
#pragma unroll
    for (int st = 0; st < SFD / 8; ++st) {
      const int c0 = d0 + 8 * st;
      FragA a[2];
      FragB bk[SNB];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        split_a(a[i], ld2(sm.q + sw<DH>(r0 + 16 * i + g, c0 + 2 * t)),
                ld2(sm.q + sw<DH>(r0 + 16 * i + g + 8, c0 + 2 * t)));
#pragma unroll
      for (int n = 0; n < SNB; ++n)
        split_b(bk[n], ld2(ks + sw<DH>(8 * n + g, c0 + 2 * t)));
      if (st % 4 == 2 && drop.on) {
        const int nb = 2 * half + st / 4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t w[4];
          drop_words(w, drop.seed, (uint32_t)bh,
                     (uint32_t)(q0 + r0 + 16 * i + g),
                     (uint32_t)(kt * SK + 8 * nb), t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            keep |= (w[e] < drop.thresh ? 1u : 0u) << (16 * i + 4 * nb + e);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) mma3s(ss[i], sb[i], a[i], bk);
    }

    // 2. the strip's exchange: S = half 0 + half 1, the keep bits of all
    // 32 keys
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < SNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm.part[warp][16 * i + 4 * n + e][lane] = ss[i][n][e] + sb[i][n][e];
    sm.keep[warp][lane] = keep;
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + strip));
    keep = drop.on ? sm.keep[strip][lane] | sm.keep[strip + 2][lane]
                   : 0xFFFFFFFFu;
    FragA pa[2][SNB];
    float alpha[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s[SNB][4];
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < SNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sm.part[strip][16 * i + 4 * n + e][lane]
                          + sm.part[strip + 2][16 * i + 4 * n + e][lane];
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
      for (int n = 0; n < SNB; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = s[n][e] <= NEG_INF ? 0.f
                                    : exp2_approx(s[n][e] - m[i][e >> 1]);
          l[i][e >> 1] += p[e];
          p[e] = (keep >> (16 * i + 4 * n + e)) & 1u ? p[e] * inv_keep : 0.f;
        }
        split_a(pa[i][n], make_float2(p[0], p[1]), make_float2(p[2], p[3]));
      }
    }

    // 3. O = O alpha + P V over this warp's dims
#pragma unroll
    for (int dg = 0; dg < SFD / 8 / SPV; ++dg) {
      float pvs[2][SPV][4], pvb[2][SPV][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        zero(pvs[i]);
        zero(pvb[i]);
      }
#pragma unroll
      for (int j = 0; j < SNB; ++j) {
        FragB bv[SPV];
#pragma unroll
        for (int n = 0; n < SPV; ++n)
          load_b_cols<DH>(bv[n], vs, 8 * j, d0 + 8 * (SPV * dg + n), g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma3s(pvs[i], pvb[i], pa[i][j], bv);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < SPV; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][SPV * dg + n][e] =
                fmaf(o[i][SPV * dg + n][e], alpha[i][e >> 1],
                     pvs[i][n][e] + pvb[i][n][e]);
    }
    kt = next;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ll = l[i][h];
      ll += __shfl_xor_sync(0xffffffffu, ll, 1);
      ll += __shfl_xor_sync(0xffffffffu, ll, 2);
      const int r = q0 + r0 + 16 * i + g + 8 * h;
      if (r >= Lq) continue;
      const float den = fmaxf(ll, 1e-30f);
      const float inv = 1.f / den;
#pragma unroll
      for (int n = 0; n < SFD / 8; ++n)
        *reinterpret_cast<float2*>(op + (int64_t)r * DH + d0 + 8 * n +
                                   2 * t) =
            make_float2(o[i][n][2 * h] * inv, o[i][n][2 * h + 1] * inv);
      if (half == 0 && t == 0)
        lp[r] = (m[i][h] <= NEG_INF ? NEG_INF : m[i][h] * LN2) + logf(den);
    }
}

template <int KT>
struct DqSmem {
  float q[QT * DH];
  float dout[QT * DH];
  float k[2][KT * DH];
  float v[2][KT * DH];
  float kval[2][KT];
};

template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_d128_dq_recompute_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ kv_mask, const uint8_t* __restrict__ q_mask,
    float* __restrict__ dq, int H, int Lq, int Lk, float inv_temp,
    Drop drop) {
  constexpr int NB = KT / 8;
  constexpr int NH = DH / 16;  // 8-dim n-tiles of half the head
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem<KT>& sm = *reinterpret_cast<DqSmem<KT>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * QT;
  const float* kp = k + (int64_t)bh * Lk * DH;
  const float* vp = v + (int64_t)bh * Lk * DH;
  float* dqp = dq + (int64_t)bh * Lq * DH;
  const uint8_t* km = kv_mask + (int64_t)b * Lk;

  int qlive = 0;
  if (tid < QT) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // no valid query: dQ = 0
    for (int i = tid; i < QT * DH / 4; i += THREADS) {
      const int r = q0 + i / (DH / 4);
      if (r < Lq)
        reinterpret_cast<float4*>(dqp + (int64_t)r * DH)[i % (DH / 4)] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int nt = (Lk + KT - 1) / KT;
  copy_rows<QT>(sm.q, q + (int64_t)bh * Lq * DH, q0, Lq, tid);
  copy_rows<QT>(sm.dout, dout + (int64_t)bh * Lq * DH, q0, Lq, tid);
  int live = row_live<KT>(km, Lk, 0, tid);
  int kt = find_live<KT>(0, nt, live, km, Lk, tid);
  if (kt < nt) {
    if (tid < KT) sm.kval[0][tid] = live ? 1.f : 0.f;
    copy_rows<KT>(sm.k[0], kp, kt * KT, Lk, tid);
    copy_rows<KT>(sm.v[0], vp, kt * KT, Lk, tid);
  }
  cp_async_commit();
  int pre = row_live<KT>(km, Lk, kt + 1, tid);
  const int m0 = 16 * warp;
  const int row = q0 + m0 + g;
  float lse2[2], dl[2];
  row_stats(lse2, dl, lse + (int64_t)bh * Lq, delta + (int64_t)bh * Lq, row,
            Lq);
  const float sc = inv_temp * LOG2E;
  float acc[DH / 8][4];
  zero(acc);
  for (int buf = 0; kt < nt; buf ^= 1) {
    cp_async_wait<0>();
    const int next = find_live<KT>(kt + 1, nt, pre, km, Lk, tid);
    if (next < nt) {
      if (tid < KT) sm.kval[buf ^ 1][tid] = pre ? 1.f : 0.f;
      copy_rows<KT>(sm.k[buf ^ 1], kp, next * KT, Lk, tid);
      copy_rows<KT>(sm.v[buf ^ 1], vp, next * KT, Lk, tid);
      cp_async_commit();
    }
    pre = row_live<KT>(km, Lk, next + 1, tid);
    const float* ks_t = sm.k[buf];

    float s[NB][4], dp[NB][4];
    zero(s);
    zero(dp);
    mma_abt<NB>(s, sm.q, m0, ks_t, g, t);
    mma_abt<NB>(dp, sm.dout, m0, sm.v[buf], g, t);
    const uint32_t kb =
        drop.on ? keep_bits_n<NB>(drop, (uint32_t)bh, (uint32_t)row,
                                  (uint32_t)(kt * KT), t)
                : 0u;
    probs_and_ds(s, dp, sm.kval[buf], sc, lse2, dl, drop, kb, t);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float part[NH][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        FragA a;
        c_to_a(a, dp[j]);
        FragB bk[NH];
#pragma unroll
        for (int n = 0; n < NH; ++n)
          load_b_cols<DH>(bk[n], ks_t, 8 * j, DH / 2 * half + 8 * n, g, t);
        mma3_row(part, a, bk);
      }
      add_part(acc, part, NH * half);
    }
    kt = next;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= Lq) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(dqp + (int64_t)r * DH + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * inv_temp, acc[n][2 * h + 1] * inv_temp);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int KT, int PVN>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* kv_mask, const void* q_mask, void* out,
                       void* lse, int B, int H, int Lq, int Lk,
                       float inv_temp, const Drop& drop,
                       cudaStream_t stream) {
  constexpr int smem = (int)sizeof(FwdSmem<KT>);
  const cudaError_t err = prepare(flash_fwd_d128_rows_kernel<KT, PVN>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lq + QT - 1) / QT), (unsigned)(B * H));
  flash_fwd_d128_rows_kernel<KT, PVN><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<float*>(out),
      static_cast<float*>(lse), H, Lq, Lk, inv_temp, drop);
  return cudaGetLastError();
}

cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* kv_mask, const void* q_mask, void* out,
                         void* lse, int B, int H, int Lq, int Lk,
                         float inv_temp, const Drop& drop,
                         cudaStream_t stream) {
  constexpr int smem = (int)sizeof(SplitSmem);
  const cudaError_t err = prepare(flash_fwd_d128_split_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lq + QT - 1) / QT), (unsigned)(B * H));
  flash_fwd_d128_split_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<float*>(out),
      static_cast<float*>(lse), H, Lq, Lk, inv_temp, drop);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* kv_mask, const void* q_mask, void* dq,
                      int B, int H, int Lq, int Lk, float inv_temp,
                      const Drop& drop, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(DqSmem<KT>);
  const cudaError_t err =
      prepare(flash_bwd_d128_dq_recompute_kernel<KT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lq + QT - 1) / QT), (unsigned)(B * H));
  flash_bwd_d128_dq_recompute_kernel<KT><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<float*>(dq), H, Lq,
      Lk, inv_temp, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_d128_designs

using csn_d128_designs::Drop;

// forward variant v: 0 = 32-key tiles, P V by 8 n-tiles; 1 = 64-key
// tiles, by 8; 2 = the D = 256 body at half the width. f32 q, k, v
// [B, H, L, 128], 16-byte aligned; out [B, H, Lq, 128], lse [B, H, Lq]
// f32.
extern "C" int csn_flash_d128_fwd_design(
    int variant, const void* q, const void* k, const void* v,
    const void* kv_mask, const void* q_mask, void* out, void* lse, int B,
    int H, int Lq, int Lk, float inv_temp, uint64_t seed, uint32_t thresh,
    float inv_keep, int use_drop, void* stream) {
  const Drop drop{seed, thresh, inv_keep, use_drop, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CSN_FWD(KT, PVN)                                                   \
  return csn_d128_designs::launch_fwd<KT, PVN>(q, k, v, kv_mask, q_mask,  \
                                               out, lse, B, H, Lq, Lk,    \
                                               inv_temp, drop, s)
  switch (variant) {
    case 0: CSN_FWD(32, 8);
    case 1: CSN_FWD(64, 8);
    case 2:
      return csn_d128_designs::launch_split(q, k, v, kv_mask, q_mask, out,
                                            lse, B, H, Lq, Lk, inv_temp,
                                            drop, s);
  }
#undef CSN_FWD
  return cudaErrorInvalidValue;
}

// the dQ pass that recomputes dS, at 32-key tiles: dq [B, H, Lq, 128] f32
// from q, k, v, dout and the forward's lse and delta = rowsum(dO o O)
extern "C" int csn_flash_d128_dq_recompute(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask,
    const void* q_mask, void* dq, int B, int H, int Lq, int Lk,
    float inv_temp, uint64_t seed, uint32_t thresh, float inv_keep,
    int use_drop, void* stream) {
  const Drop drop{seed, thresh, inv_keep, use_drop, 0, 0};
  return csn_d128_designs::launch_dq<32>(
      q, k, v, dout, lse, delta, kv_mask, q_mask, dq, B, H, Lq, Lk, inv_temp,
      drop, static_cast<cudaStream_t>(stream));
}
