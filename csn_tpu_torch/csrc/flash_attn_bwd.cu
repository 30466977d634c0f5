// Masked flash attention backward (dQ, dK, dV from the saved log-sum-exp),
// with the forward's attention dropout regenerated in the kernel.
//
// Replaces: csn_tpu/ops/flash.py _flash_backward (Pallas body
// _bwd_fused_kernel), which the JAX package reaches through the custom VJP of
// flash_attention from ops/attention.py MultiHeadAttention.
//
// Computes, per (batch*head), with s = (q / T) . k masked to NEG_INF at
// invalid keys, p = exp(s - lse) (the true softmax), the dropout mask m and
// keep = 1 - rate (m = 1, keep = 1 without dropout), and delta = rowsum(dO o
// O) computed by the caller:
//   dP = dO . v^T,  dPd = m * dP / keep,  dS = p * (dPd - delta),
//   dV = (m * p / keep)^T . dO,  dK = dS^T . (q / T),  dQ = dS . k / T,
// in f32, stored in the type of q, k, v. Query tiles with no valid query and
// key tiles with no valid key are skipped, as in the forward (flash_attn.cu):
// a skipped key tile gets dK = dV = 0, a skipped query tile dQ = 0.
//
// What bounds it on the H100: seven 64x64x64 tile products per (query tile,
// key tile) pair (four in the dK/dV pass, three in the dQ pass) against the
// forward's two, all on the CUDA cores in f32 (FMA), so it is compute-bound
// like the forward; the tensor-core (wgmma) form is later work.
//
// Design: the classic two-pass split, deterministic and without atomics. The
// TPU kernel accumulates dQ in a VMEM-resident [Lq, D] plane across its
// sequential (key, query) grid; a block's shared memory has no room for that
// plane and blocks run in no order, so the work is split in two kernels:
//  * dkdv: one block of 256 threads per (batch*head, 64-key tile) keeps its K
//    and V tile in shared memory and loops over the query tiles; each thread
//    owns 4 keys x 4 queries of the transposed score tile and 4 keys x 4 dims
//    of dK and dV in registers.
//  * dq: one block per (batch*head, 64-query tile) keeps Q and dO and loops
//    over the key tiles; each thread owns 4 queries x 4 keys of the score
//    tile and 4 queries x 4 dims of dQ.
// dq recomputes s, p and dP that dkdv computed too: two of the seven tile
// products are spent on not sharing dQ across blocks.
//
// Wide heads (D = 128, 256: the MID-FC heads use 256 per head) take the
// kernels of flash_bwd_wide.cuh, re-tiled so that shared memory and the
// accumulator registers stay within a block's limits; the D = 64 kernels
// below are unchanged.

#include "common.cuh"
#include "flash_bwd_wide.cuh"

namespace {

constexpr int BQ = 64;        // queries per tile
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PAD = 4;
constexpr int SQ = BQ + PAD;
constexpr int SK = BKV + PAD;
constexpr float NEG_INF = -1e30f;

struct Drop {
  uint64_t seed;
  uint32_t thresh;
  float inv_keep;
  int on;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// --- dK, dV: one block per (batch*head, key tile) ---------------------------

template <int D>
constexpr size_t dkdv_smem_floats() {
  return 4 * (size_t)D * SK        // KsT, VsT, QsT, dOT (QsT, dOT with SQ)
         + 2 * (size_t)BQ * D      // Qs, dOs row-major
         + 2 * (size_t)BQ * SK     // Ps, dSs: [query][key]
         + 2 * (size_t)BQ;         // lse, delta of the query tile
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const uint8_t* __restrict__ kv_mask,
                      const uint8_t* __restrict__ q_mask, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Lq, int Lk,
                      float inv_temp, Drop drop) {
  static_assert(SQ == SK, "QsT/dOT share the key-tile stride");
  extern __shared__ __align__(16) float smem[];
  float* KsT = smem;             // [D][SK]
  float* VsT = KsT + D * SK;     // [D][SK]
  float* QsT = VsT + D * SK;     // [D][SQ] scaled queries
  float* dOT = QsT + D * SQ;     // [D][SQ]
  float* Qs = dOT + D * SQ;      // [BQ][D] scaled queries
  float* dOs = Qs + BQ * D;      // [BQ][D]
  float* Ps = dOs + BQ * D;      // [BQ][SK] m * p / keep
  float* dSs = Ps + BQ * SK;     // [BQ][SK]
  float* lse_s = dSs + BQ * SK;  // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]
  __shared__ int kvalid[BKV];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // queries tx*4.. of the score tile; dims tx*4..
  const int ty = tid / 16;  // keys ty*4 .. ty*4+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kv0 = blockIdx.x * BKV;
  const T* qp = q + (int64_t)bh * Lq * D;
  const T* dop = dout + (int64_t)bh * Lq * D;
  const T* kp = k + (int64_t)bh * Lk * D;
  const T* vp = v + (int64_t)bh * Lk * D;
  const float* lp = lse + (int64_t)bh * Lq;
  const float* dp_ = delta + (int64_t)bh * Lq;
  T* dkp = dk + (int64_t)bh * Lk * D;
  T* dvp = dv + (int64_t)bh * Lk * D;

  int live = 0;
  if (tid < BKV) {
    const int r = kv0 + tid;
    live = r < Lk && kv_mask[(int64_t)b * Lk + r];
    kvalid[tid] = live;
  }
  if (!__syncthreads_or(live)) {  // no valid key: dK = dV = 0
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = kv0 + i / D;
      if (r < Lk) {
        csn::store(0.f, dkp + (int64_t)r * D + i % D);
        csn::store(0.f, dvp + (int64_t)r * D + i % D);
      }
    }
    return;
  }
  for (int i = tid; i < BKV * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const bool ok = kv0 + r < Lk;
    KsT[d * SK + r] = ok ? csn::to_f32(kp[(int64_t)(kv0 + r) * D + d]) : 0.f;
    VsT[d * SK + r] = ok ? csn::to_f32(vp[(int64_t)(kv0 + r) * D + d]) : 0.f;
  }

  float acc_k[4][4], acc_v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    int qlive = 0;
    if (tid < BQ) {
      const int r = q0 + tid;
      const bool in = r < Lq;
      qlive = in && q_mask[(int64_t)b * Lq + r];
      lse_s[tid] = in ? lp[r] : 0.f;
      delta_s[tid] = in ? dp_[r] : 0.f;
    }
    // also publishes lse_s/delta_s, and orders the previous tile's reads of
    // Qs/dOs/Ps/dSs before this tile's writes
    if (!__syncthreads_or(qlive)) continue;

    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool ok = q0 + r < Lq;
      const float qv =
          ok ? csn::to_f32(qp[(int64_t)(q0 + r) * D + d]) * inv_temp : 0.f;
      const float gv = ok ? csn::to_f32(dop[(int64_t)(q0 + r) * D + d]) : 0.f;
      QsT[d * SQ + r] = qv;
      Qs[r * D + d] = qv;
      dOT[d * SQ + r] = gv;
      dOs[r * D + d] = gv;
    }
    __syncthreads();

    // transposed tiles: st[i][j], dpt[i][j] for key ty*4+i, query tx*4+j
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 kk = ld4(&KsT[d * SK + ty * 4]);
      const float4 vv = ld4(&VsT[d * SK + ty * 4]);
      const float4 qq = ld4(&QsT[d * SQ + tx * 4]);
      const float4 gg = ld4(&dOT[d * SQ + tx * 4]);
      const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
      const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
      const float ga[4] = {gg.x, gg.y, gg.z, gg.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(ka[i], qa[j], st[i][j]);
          dpt[i][j] = fmaf(va[i], ga[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qr = tx * 4 + j;
      uint32_t bw[4] = {0u, 0u, 0u, 0u};
      if (drop.on) {
        const csn::U4 bits = csn::dropout_bits(
            drop.seed, (uint32_t)bh, (uint32_t)(q0 + qr),
            (uint32_t)((kv0 + ty * 4) >> 2));
        bw[0] = bits.x;
        bw[1] = bits.y;
        bw[2] = bits.z;
        bw[3] = bits.w;
      }
      float pn[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = kvalid[ty * 4 + i] ? st[i][j] : NEG_INF;
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
      *reinterpret_cast<float4*>(&Ps[qr * SK + ty * 4]) =
          make_float4(pn[0], pn[1], pn[2], pn[3]);
      *reinterpret_cast<float4*>(&dSs[qr * SK + ty * 4]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float4 pp = ld4(&Ps[r * SK + ty * 4]);
      const float4 ss = ld4(&dSs[r * SK + ty * 4]);
      const float4 gg = ld4(&dOs[r * D + tx * 4]);
      const float4 qq = ld4(&Qs[r * D + tx * 4]);
      const float pa[4] = {pp.x, pp.y, pp.z, pp.w};
      const float sa[4] = {ss.x, ss.y, ss.z, ss.w};
      const float ga[4] = {gg.x, gg.y, gg.z, gg.w};
      const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc_v[i][c] = fmaf(pa[i], ga[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(sa[i], qa[c], acc_k[i][c]);
        }
    }
    // the next tile's first barrier (__syncthreads_or) orders these reads
    // before its writes
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = kv0 + ty * 4 + i;
    if (r >= Lk) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      csn::store(acc_k[i][c], dkp + (int64_t)r * D + tx * 4 + c);
      csn::store(acc_v[i][c], dvp + (int64_t)r * D + tx * 4 + c);
    }
  }
}

// --- dQ: one block per (batch*head, query tile) -----------------------------

template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * (size_t)D * SK        // QsT, dOT, KsT, VsT
         + (size_t)BKV * D         // Ks row-major
         + (size_t)BKV * SQ;       // dSs: [key][query]
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const uint8_t* __restrict__ kv_mask,
                    const uint8_t* __restrict__ q_mask, T* __restrict__ dq,
                    int H, int Lq, int Lk, float inv_temp, Drop drop) {
  extern __shared__ __align__(16) float smem[];
  float* QsT = smem;            // [D][SQ] scaled queries
  float* dOT = QsT + D * SQ;    // [D][SQ]
  float* KsT = dOT + D * SQ;    // [D][SK]
  float* VsT = KsT + D * SK;    // [D][SK]
  float* Ks = VsT + D * SK;     // [BKV][D]
  float* dSs = Ks + BKV * D;    // [BKV][SQ]
  __shared__ int kvalid[BKV];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // keys tx*4.. of the score tile; dims tx*4..
  const int ty = tid / 16;  // queries ty*4 .. ty*4+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + (int64_t)bh * Lq * D;
  const T* dop = dout + (int64_t)bh * Lq * D;
  const T* kp = k + (int64_t)bh * Lk * D;
  const T* vp = v + (int64_t)bh * Lk * D;
  T* dqp = dq + (int64_t)bh * Lq * D;

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

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int kv0 = 0; kv0 < Lk; kv0 += BKV) {
    int live = 0;
    if (tid < BKV) {
      const int r = kv0 + tid;
      live = r < Lk && kv_mask[(int64_t)b * Lk + r];
      kvalid[tid] = live;
    }
    // also orders the previous tile's reads of Ks/dSs before these writes
    if (!__syncthreads_or(live)) continue;

    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool ok = kv0 + r < Lk;
      const float kv = ok ? csn::to_f32(kp[(int64_t)(kv0 + r) * D + d]) : 0.f;
      KsT[d * SK + r] = kv;
      Ks[r * D + d] = kv;
      VsT[d * SK + r] = ok ? csn::to_f32(vp[(int64_t)(kv0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4], dpv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dpv[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qq = ld4(&QsT[d * SQ + ty * 4]);
      const float4 gg = ld4(&dOT[d * SQ + ty * 4]);
      const float4 kk = ld4(&KsT[d * SK + tx * 4]);
      const float4 vv = ld4(&VsT[d * SK + tx * 4]);
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

    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t bw[4] = {0u, 0u, 0u, 0u};
      if (drop.on) {
        const csn::U4 bits = csn::dropout_bits(
            drop.seed, (uint32_t)bh, (uint32_t)(q0 + ty * 4 + i),
            (uint32_t)((kv0 + tx * 4) >> 2));
        bw[0] = bits.x;
        bw[1] = bits.y;
        bw[2] = bits.z;
        bw[3] = bits.w;
      }
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
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 ss = ld4(&dSs[kk * SQ + ty * 4]);
      const float4 kr = ld4(&Ks[kk * D + tx * 4]);
      const float sa[4] = {ss.x, ss.y, ss.z, ss.w};
      const float ka[4] = {kr.x, kr.y, kr.z, kr.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(sa[i], ka[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      csn::store(acc[i][c] * inv_temp, dqp + (int64_t)r * D + tx * 4 + c);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* kv_mask, const void* q_mask, void* dq, void* dk,
                   void* dv, int B, int H, int Lq, int Lk, float inv_temp,
                   Drop drop, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem_floats<D>() * sizeof(float);
  constexpr size_t smem_q = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
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
    const dim3 grid_kv((unsigned)((Lk + BKV - 1) / BKV), (unsigned)(B * H));
    flash_bwd_dkdv_kernel<T, D><<<grid_kv, THREADS, smem_kv, stream>>>(
        qt, kt, vt, gt, lt, dt, km, qm, static_cast<T*>(dk),
        static_cast<T*>(dv), H, Lq, Lk, inv_temp, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q((unsigned)((Lq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_bwd_dq_kernel<T, D><<<grid_q, THREADS, smem_q, stream>>>(
      qt, kt, vt, gt, lt, dt, km, qm, static_cast<T*>(dq), H, Lq, Lk,
      inv_temp, drop);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq: [B, H, Lq, D]; k, v, dk, dv: [B, H, Lk, D], all contiguous in
// one type; lse and delta [B, H, Lq] f32; kv_mask [B, Lk] and q_mask [B, Lq]
// bool bytes. D is 64, 128 or 256. Dropout arguments as csn_flash_attn_fwd's.
extern "C" int csn_flash_attn_bwd(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* kv_mask, const void* q_mask,
                                  void* dq, void* dk, void* dv, int B, int H,
                                  int Lq, int Lk, int D, float inv_temp,
                                  uint64_t seed, uint32_t thresh,
                                  float inv_keep, int use_drop,
                                  void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 || D == 256) {
    const csn_wide_bwd::Drop wd{seed, thresh, inv_keep, use_drop, 0, 0};
#define CSN_WIDE(T, DD)                                                    \
  return csn_wide_bwd::launch_bwd_wide<T, T, DD>(q, k, v, dout, lse, delta, \
                                                 kv_mask, q_mask, dq, dk,  \
                                                 dv, B, H, Lq, Lk,         \
                                                 inv_temp, wd, s)
    if (dtype == csn::kF32) {
      if (D == 128) CSN_WIDE(float, 128);
      CSN_WIDE(float, 256);
    }
    if (dtype == csn::kBF16) {
      if (D == 128) CSN_WIDE(__nv_bfloat16, 128);
      CSN_WIDE(__nv_bfloat16, 256);
    }
#undef CSN_WIDE
    return cudaErrorInvalidValue;
  }
  if (D != 64) return cudaErrorInvalidValue;
  const Drop drop{seed, thresh, inv_keep, use_drop};
  if (dtype == csn::kF32)
    return launch<float, 64>(q, k, v, dout, lse, delta, kv_mask, q_mask, dq,
                             dk, dv, B, H, Lq, Lk, inv_temp, drop, s);
  if (dtype == csn::kBF16)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, kv_mask,
                                     q_mask, dq, dk, dv, B, H, Lq, Lk,
                                     inv_temp, drop, s);
  return cudaErrorInvalidValue;
}
