// Masked flash attention backward in f32 arithmetic on the CUDA cores for D
// a multiple of 64 up to 256, for one key block of a ring:
// flash_attn_block_bwd.cu (the ring's per-hop backward at D = 64 and 128 in
// f32 and bf16; at D = 256 it runs flash_tf32_bwd.cuh in f32 and
// flash_bf16_wide_bwd.cuh in bf16). K2's backward runs on the tensor cores
// at every head dim (flash_attn_bwd.cu).
//
// Same function as flash_attn_bwd.cu's tensor-core kernels, in the same two
// deterministic passes (dK/dV per key tile, dQ per query tile), from the
// saved log-sum-exp rows and delta = rowsum(dO o O). Given the GLOBAL lse,
// delta and dO and ONE key block, the passes return that block's dK and dV
// and its contribution to dQ; the contributions of disjoint blocks add up to
// the full dQ, which is why DQ_T may be float (accumulated across hops)
// while dK and dV keep the activation type. row_off / col_off place the
// block in the global score matrix for the dropout mask.
//
// Tiling for wide heads: K, V, Q and dO tiles whole in f32 shared memory
// would not fit at D = 256. Here:
//  * dkdv: one block of 256 threads per 32 keys (not 64): K and V stay whole
//    and transposed ([D][36] each, 74 KB at D = 256), Q and dO pass through
//    two [64][68] chunk buffers, 64 dims at a time: once transposed for the
//    score and dP tiles, and once row-major for the dK / dV products. A
//    thread owns 2 keys x 4 queries of the tiles and 2 keys x D/16 dims of
//    dK and of dV (64 registers at D = 256). 127 KB of shared memory.
//  * dq: one block per 64 queries: Q and dO stay whole and transposed
//    ([D][68] each, 139 KB at D = 256), K and V pass through the two chunk
//    buffers the same way. A thread owns 4 queries x 4 keys of the tiles and
//    4 queries x D/16 dims of dQ. 191 KB of shared memory.

#pragma once

#include "common.cuh"

namespace csn_wide_bwd {

constexpr int BQ = 64;        // queries per tile
constexpr int BKV = 64;       // keys per tile of the dq pass
constexpr int BK2 = 32;       // keys per block of the dkdv pass
constexpr int DC = 64;        // head dims per chunk
constexpr int THREADS = 256;  // 16 x 16
constexpr int PAD = 4;
constexpr int SQ = BQ + PAD;    // 68
constexpr int SK = BKV + PAD;   // 68
constexpr int SK2 = BK2 + PAD;  // 36
constexpr float NEG_INF = -1e30f;

using Drop = csn::Drop;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// --- dK, dV: one block per (batch*head, 32 keys) ----------------------------

template <int D>
constexpr size_t dkdv_smem_floats() {
  return 2 * (size_t)D * SK2      // KsT, VsT
         + 2 * (size_t)DC * SQ    // the Q and dO chunk buffers
         + 2 * (size_t)BQ * SK2   // Ps, dSs: [query][key]
         + 2 * (size_t)BQ;        // lse, delta of the query tile
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const uint8_t* __restrict__ kv_mask,
                           const uint8_t* __restrict__ q_mask,
                           T* __restrict__ dk, T* __restrict__ dv, int H,
                           int Lq, int Lk, float inv_temp, Drop drop) {
  static_assert(D % DC == 0 && D <= 256, "D walks in chunks of 64");
  constexpr int NC = D / DC;
  extern __shared__ __align__(16) float smem[];
  float* KsT = smem;               // [D][SK2]
  float* VsT = KsT + D * SK2;      // [D][SK2]
  float* Qc = VsT + D * SK2;       // [DC][SQ] transposed, or [BQ][DC]
  float* Gc = Qc + DC * SQ;        // the same for dO
  float* Ps = Gc + DC * SQ;        // [BQ][SK2] m * p / keep
  float* dSs = Ps + BQ * SK2;      // [BQ][SK2]
  float* lse_s = dSs + BQ * SK2;   // [BQ]
  float* delta_s = lse_s + BQ;     // [BQ]
  __shared__ int kvalid[BK2];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // queries tx*4.. of the tiles; dims tx*4.. a chunk
  const int ty = tid / 16;  // keys ty*2, ty*2+1
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kv0 = blockIdx.x * BK2;
  const T* qp = q + (int64_t)bh * Lq * D;
  const T* dop = dout + (int64_t)bh * Lq * D;
  const T* kp = k + (int64_t)bh * Lk * D;
  const T* vp = v + (int64_t)bh * Lk * D;
  const float* lp = lse + (int64_t)bh * Lq;
  const float* dp_ = delta + (int64_t)bh * Lq;
  T* dkp = dk + (int64_t)bh * Lk * D;
  T* dvp = dv + (int64_t)bh * Lk * D;

  int live = 0;
  if (tid < BK2) {
    const int r = kv0 + tid;
    live = r < Lk && kv_mask[(int64_t)b * Lk + r];
    kvalid[tid] = live;
  }
  if (!__syncthreads_or(live)) {  // no valid key: dK = dV = 0
    for (int i = tid; i < BK2 * D; i += THREADS) {
      const int r = kv0 + i / D;
      if (r < Lk) {
        csn::store(0.f, dkp + (int64_t)r * D + i % D);
        csn::store(0.f, dvp + (int64_t)r * D + i % D);
      }
    }
    return;
  }
  for (int i = tid; i < BK2 * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const bool ok = kv0 + r < Lk;
    KsT[d * SK2 + r] = ok ? csn::to_f32(kp[(int64_t)(kv0 + r) * D + d]) : 0.f;
    VsT[d * SK2 + r] = ok ? csn::to_f32(vp[(int64_t)(kv0 + r) * D + d]) : 0.f;
  }

  float acc_k[2][4 * NC], acc_v[2][4 * NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    int qlive = 0;
    if (tid < BQ) {
      const int r = q0 + tid;
      const bool in = r < Lq;
      qlive = in && q_mask[(int64_t)b * Lq + r];
      lse_s[tid] = in ? lp[r] : 0.f;
      delta_s[tid] = in ? dp_[r] : 0.f;
    }
    // also publishes lse_s/delta_s (and KsT/VsT the first time), and orders
    // the previous tile's reads of the chunk buffers before this tile's
    // writes
    if (!__syncthreads_or(qlive)) continue;

    // transposed tiles: st[i][j], dpt[i][j] for key ty*2+i, query tx*4+j
    float st[2][4], dpt[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;

    for (int c = 0; c < NC; ++c) {
      for (int i = tid; i < BQ * DC; i += THREADS) {
        const int r = i / DC, d = i % DC;
        const bool ok = q0 + r < Lq;
        const int64_t o = (int64_t)(q0 + r) * D + c * DC + d;
        Qc[d * SQ + r] = ok ? csn::to_f32(qp[o]) * inv_temp : 0.f;
        Gc[d * SQ + r] = ok ? csn::to_f32(dop[o]) : 0.f;
      }
      __syncthreads();
      const float* Kc = KsT + c * DC * SK2;
      const float* Vc = VsT + c * DC * SK2;
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        const float2 kk = ld2(&Kc[d * SK2 + ty * 2]);
        const float2 vv = ld2(&Vc[d * SK2 + ty * 2]);
        const float4 qq = ld4(&Qc[d * SQ + tx * 4]);
        const float4 gg = ld4(&Gc[d * SQ + tx * 4]);
        const float ka[2] = {kk.x, kk.y};
        const float va[2] = {vv.x, vv.y};
        const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
        const float ga[4] = {gg.x, gg.y, gg.z, gg.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(ka[i], qa[j], st[i][j]);
            dpt[i][j] = fmaf(va[i], ga[j], dpt[i][j]);
          }
      }
      __syncthreads();  // before the next chunk overwrites Qc / Gc
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qr = tx * 4 + j;
      uint32_t bw[2] = {0u, 0u};
      if (drop.on)
        csn::dropout_words<2>(drop.seed, (uint32_t)bh,
                              (uint32_t)(drop.row_off + q0 + qr),
                              (uint32_t)(drop.col_off + kv0 + ty * 2), bw);
      float pn[2], ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float s = kvalid[ty * 2 + i] ? st[i][j] : NEG_INF;
        const float p = expf(s - lse_s[qr]);
        float dpd = dpt[i][j];
        pn[i] = p;
        if (drop.on) {
          const bool keep = bw[i] < drop.thresh;
          dpd = keep ? dpd * drop.inv_keep : 0.f;
          pn[i] = keep ? p * drop.inv_keep : 0.f;
        }
        ds[i] = p * (dpd - delta_s[qr]);
      }
      *reinterpret_cast<float2*>(&Ps[qr * SK2 + ty * 2]) =
          make_float2(pn[0], pn[1]);
      *reinterpret_cast<float2*>(&dSs[qr * SK2 + ty * 2]) =
          make_float2(ds[0], ds[1]);
    }

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      for (int i = tid; i < BQ * DC; i += THREADS) {
        const int r = i / DC, d = i % DC;
        const bool ok = q0 + r < Lq;
        const int64_t o = (int64_t)(q0 + r) * D + c * DC + d;
        Qc[r * DC + d] = ok ? csn::to_f32(qp[o]) * inv_temp : 0.f;
        Gc[r * DC + d] = ok ? csn::to_f32(dop[o]) : 0.f;
      }
      __syncthreads();  // publishes the chunk (and Ps / dSs, the first time)
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float2 pp = ld2(&Ps[r * SK2 + ty * 2]);
        const float2 ss = ld2(&dSs[r * SK2 + ty * 2]);
        const float4 gg = ld4(&Gc[r * DC + tx * 4]);
        const float4 qq = ld4(&Qc[r * DC + tx * 4]);
        const float pa[2] = {pp.x, pp.y};
        const float sa[2] = {ss.x, ss.y};
        const float ga[4] = {gg.x, gg.y, gg.z, gg.w};
        const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc_v[i][c * 4 + e] = fmaf(pa[i], ga[e], acc_v[i][c * 4 + e]);
            acc_k[i][c * 4 + e] = fmaf(sa[i], qa[e], acc_k[i][c * 4 + e]);
          }
      }
      __syncthreads();  // before the next chunk or tile overwrites them
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kv0 + ty * 2 + i;
    if (r >= Lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t o = (int64_t)r * D + c * DC + tx * 4 + e;
        csn::store(acc_k[i][c * 4 + e], dkp + o);
        csn::store(acc_v[i][c * 4 + e], dvp + o);
      }
  }
}

// --- dQ: one block per (batch*head, 64 queries) -----------------------------

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * (size_t)D * SQ       // QsT, dOT
         + 2 * (size_t)DC * SK    // the K and V chunk buffers
         + (size_t)BKV * SQ;      // dSs: [key][query]
}

template <typename T, typename DQ_T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const uint8_t* __restrict__ kv_mask,
                         const uint8_t* __restrict__ q_mask,
                         DQ_T* __restrict__ dq, int H, int Lq, int Lk,
                         float inv_temp, Drop drop) {
  static_assert(D % DC == 0 && D <= 256, "D walks in chunks of 64");
  constexpr int NC = D / DC;
  extern __shared__ __align__(16) float smem[];
  float* QsT = smem;             // [D][SQ] scaled queries
  float* dOT = QsT + D * SQ;     // [D][SQ]
  float* Kc = dOT + D * SQ;      // [DC][SK] transposed, or [BKV][DC]
  float* Vc = Kc + DC * SK;      // [DC][SK] transposed
  float* dSs = Vc + DC * SK;     // [BKV][SQ]
  __shared__ int kvalid[BKV];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // keys tx*4.. of the tiles; dims tx*4.. of a chunk
  const int ty = tid / 16;  // queries ty*4 .. ty*4+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + (int64_t)bh * Lq * D;
  const T* dop = dout + (int64_t)bh * Lq * D;
  const T* kp = k + (int64_t)bh * Lk * D;
  const T* vp = v + (int64_t)bh * Lk * D;
  DQ_T* dqp = dq + (int64_t)bh * Lq * D;

  int qlive = 0;
  if (tid < BQ) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // no valid query: dQ = 0
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = q0 + i / D;
      if (r < Lq) csn::store(0.f, dqp + (int64_t)r * D + i % D);
    }
    return;
  }
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const bool ok = q0 + r < Lq;
    QsT[d * SQ + r] =
        ok ? csn::to_f32(qp[(int64_t)(q0 + r) * D + d]) * inv_temp : 0.f;
    dOT[d * SQ + r] = ok ? csn::to_f32(dop[(int64_t)(q0 + r) * D + d]) : 0.f;
  }
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse_r[i] = r < Lq ? lse[(int64_t)bh * Lq + r] : 0.f;
    delta_r[i] = r < Lq ? delta[(int64_t)bh * Lq + r] : 0.f;
  }

  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  for (int kv0 = 0; kv0 < Lk; kv0 += BKV) {
    int live = 0;
    if (tid < BKV) {
      const int r = kv0 + tid;
      live = r < Lk && kv_mask[(int64_t)b * Lk + r];
      kvalid[tid] = live;
    }
    // also publishes QsT/dOT the first time, and orders the previous tile's
    // reads of the chunk buffers and dSs before these writes
    if (!__syncthreads_or(live)) continue;

    float s[4][4], dpv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dpv[i][j] = 0.f;

    for (int c = 0; c < NC; ++c) {
      for (int i = tid; i < BKV * DC; i += THREADS) {
        const int r = i / DC, d = i % DC;
        const bool ok = kv0 + r < Lk;
        const int64_t o = (int64_t)(kv0 + r) * D + c * DC + d;
        Kc[d * SK + r] = ok ? csn::to_f32(kp[o]) : 0.f;
        Vc[d * SK + r] = ok ? csn::to_f32(vp[o]) : 0.f;
      }
      __syncthreads();
      const float* Qc = QsT + c * DC * SQ;
      const float* Gc = dOT + c * DC * SQ;
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        const float4 qq = ld4(&Qc[d * SQ + ty * 4]);
        const float4 gg = ld4(&Gc[d * SQ + ty * 4]);
        const float4 kk = ld4(&Kc[d * SK + tx * 4]);
        const float4 vv = ld4(&Vc[d * SK + tx * 4]);
        const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
        const float ga[4] = {gg.x, gg.y, gg.z, gg.w};
        const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
            dpv[i][j] = fmaf(ga[i], va[j], dpv[i][j]);
          }
      }
      __syncthreads();  // before the next chunk overwrites Kc / Vc
    }

    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t bw[4] = {0u, 0u, 0u, 0u};
      if (drop.on)
        csn::dropout_words<4>(drop.seed, (uint32_t)bh,
                              (uint32_t)(drop.row_off + q0 + ty * 4 + i),
                              (uint32_t)(drop.col_off + kv0 + tx * 4), bw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = kvalid[tx * 4 + j] ? s[i][j] : NEG_INF;
        const float p = expf(sv - lse_r[i]);
        float dpd = dpv[i][j];
        if (drop.on) dpd = bw[j] < drop.thresh ? dpd * drop.inv_keep : 0.f;
        ds[i][j] = p * (dpd - delta_r[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dSs[(tx * 4 + j) * SQ + ty * 4]) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      for (int i = tid; i < BKV * DC; i += THREADS) {
        const int r = i / DC, d = i % DC;
        const bool ok = kv0 + r < Lk;
        Kc[r * DC + d] =
            ok ? csn::to_f32(kp[(int64_t)(kv0 + r) * D + c * DC + d]) : 0.f;
      }
      __syncthreads();  // publishes the chunk (and dSs, the first time)
#pragma unroll 4
      for (int kk = 0; kk < BKV; ++kk) {
        const float4 ss = ld4(&dSs[kk * SQ + ty * 4]);
        const float4 kr = ld4(&Kc[kk * DC + tx * 4]);
        const float sa[4] = {ss.x, ss.y, ss.z, ss.w};
        const float ka[4] = {kr.x, kr.y, kr.z, kr.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] = fmaf(sa[i], ka[e], acc[i][c * 4 + e]);
      }
      __syncthreads();  // before the next chunk or tile overwrites them
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        csn::store(acc[i][c * 4 + e] * inv_temp,
                   dqp + (int64_t)r * D + c * DC + tx * 4 + e);
  }
}

template <typename T, typename DQ_T, int D>
cudaError_t launch_bwd_wide(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* kv_mask,
                            const void* q_mask, void* dq, void* dk, void* dv,
                            int B, int H, int Lq, int Lk, float inv_temp,
                            Drop drop, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem_floats<D>() * sizeof(float);
  constexpr size_t smem_q = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_wide_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_wide_dq_kernel<T, DQ_T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  const uint8_t* km = static_cast<const uint8_t*>(kv_mask);
  const uint8_t* qm = static_cast<const uint8_t*>(q_mask);
  if (Lk > 0) {
    const dim3 grid_kv((unsigned)((Lk + BK2 - 1) / BK2), (unsigned)(B * H));
    flash_bwd_wide_dkdv_kernel<T, D><<<grid_kv, THREADS, smem_kv, stream>>>(
        qt, kt, vt, gt, lt, dt, km, qm, static_cast<T*>(dk),
        static_cast<T*>(dv), H, Lq, Lk, inv_temp, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q((unsigned)((Lq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_bwd_wide_dq_kernel<T, DQ_T, D><<<grid_q, THREADS, smem_q, stream>>>(
      qt, kt, vt, gt, lt, dt, km, qm, static_cast<DQ_T*>(dq), H, Lq, Lk,
      inv_temp, drop);
  return cudaGetLastError();
}

}  // namespace csn_wide_bwd
