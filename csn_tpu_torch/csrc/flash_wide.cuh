// Masked flash attention forward in f32 arithmetic on the CUDA cores for D a
// multiple of 64 up to 256: the carry kernel of the ring at D = 64 and 128
// in f32 and bf16 (flash_attn_carry.cu; at D = 256 it runs the carry forms
// of flash_tf32_fwd.cuh in f32 and of flash_bf16_wide_fwd.cuh in bf16).
// Its K2 form (CARRY false: out and lse) is launched by no entry point
// since every K2 case runs on the tensor cores (flash_attn.cu); it goes with
// these ring forms' move to the tensor cores.
//
// Same function as flash_attn.cu's tensor-core kernel: online softmax over
// key tiles, masked keys at NEG_INF, the denominator floored at 1e-30,
// dropout on the numerator only. At D = 256, f32 Q, K and V tiles whole in
// shared memory would need 222 KB, so here only the scaled query tile stays
// whole ([D][68] f32, 70 KB at D = 256) and the block walks D in chunks of 64:
// once over K chunks for the 64 x 64 score tile, and once over V chunks for
// the P.V product, each chunk through one [64][68] buffer. A thread's
// 4 x D/16 output tile holds dims chunk * 64 + tx * 4 .. + 3 of every chunk.
// That is 105 KB of shared memory and 64 accumulator registers at D = 256.
//
// With CARRY the running max m, the denominator l and the f32 accumulator
// start from the carry that the caller passes in and are written back raw
// (no division, no lse): a chain of calls over disjoint key blocks equals one
// pass over their union. A query tile with no valid query, or a block with
// no valid key, passes the carry through untouched. row_off and col_off place
// the block in the global [Lq, Lk] score matrix for the dropout mask, which
// is keyed by absolute (row, column): a ring at any world size drops exactly
// the entries of the single-device mask.

#pragma once

#include "common.cuh"

namespace csn_wide {

constexpr int BQ = 64;        // queries per block
constexpr int BKV = 64;       // keys per tile
constexpr int DC = 64;        // head dims per chunk
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 rows, tx 4 keys / 4 dims
constexpr int PAD = 4;
constexpr int SQ = BQ + PAD;  // stride of Qs and Ps
constexpr int SK = BKV + PAD; // stride of the transposed K chunk
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((size_t)D * SQ + (size_t)DC * SK +
                          (size_t)BKV * SQ) +
         sizeof(int) * BKV;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// out/lse are written when !CARRY; m/l/acc (in and out) are used when CARRY.
template <typename T, int D, bool CARRY>
__global__ void __launch_bounds__(THREADS)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ kv_mask,
                      const uint8_t* __restrict__ q_mask, T* __restrict__ out,
                      float* __restrict__ lse, const float* __restrict__ m_in,
                      const float* __restrict__ l_in,
                      const float* __restrict__ acc_in,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      float* __restrict__ acc_out, int H, int Lq, int Lk,
                      float inv_temp, uint64_t seed, uint32_t thresh,
                      float inv_keep, int use_drop, int row_off, int col_off) {
  static_assert(D % DC == 0 && D <= 256, "D walks in chunks of 64");
  constexpr int NC = D / DC;   // chunks
  constexpr int CPT = 4 * NC;  // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [D][SQ]   scaled queries, transposed
  float* KVs = Qs + D * SQ;      // [DC][SK] K chunk transposed, or
                                 // [BKV][DC] V chunk row-major
  float* Ps = KVs + DC * SK;     // [BKV][SQ] probabilities, transposed
  int* kvalid = reinterpret_cast<int*>(Ps + BKV * SQ);  // [BKV]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + (int64_t)bh * Lq * D;
  const T* kp = k + (int64_t)bh * Lk * D;
  const T* vp = v + (int64_t)bh * Lk * D;
  const int64_t row_base = (int64_t)bh * Lq;

  int qlive = 0;
  if (tid < BQ) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {
    if (CARRY) {  // padding rows: the carry passes through
      for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = q0 + i / D;
        if (r < Lq) {
          const int64_t o = (row_base + r) * D + i % D;
          acc_out[o] = acc_in[o];
        }
      }
      if (tid < BQ && q0 + tid < Lq) {
        m_out[row_base + q0 + tid] = m_in[row_base + q0 + tid];
        l_out[row_base + q0 + tid] = l_in[row_base + q0 + tid];
      }
    } else {
      for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = q0 + i / D;
        if (r < Lq) csn::store(0.f, out + (row_base + r) * D + i % D);
      }
      if (tid < BQ && q0 + tid < Lq)
        lse[row_base + q0 + tid] = NEG_INF + logf(1e-30f);
    }
    return;
  }

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int gr = q0 + r;
    Qs[d * SQ + r] =
        gr < Lq ? csn::to_f32(qp[(int64_t)gr * D + d]) * inv_temp : 0.f;
  }

  float m[4], l[4], o[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    const bool in = CARRY && r < Lq;
    m[i] = in ? m_in[row_base + r] : NEG_INF;
    l[i] = in ? l_in[row_base + r] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (in) {
        const float4 a =
            ld4(acc_in + (row_base + r) * D + c * DC + tx * 4);
        o[i][c * 4 + 0] = a.x;
        o[i][c * 4 + 1] = a.y;
        o[i][c * 4 + 2] = a.z;
        o[i][c * 4 + 3] = a.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c * 4 + e] = 0.f;
      }
    }
  }

  for (int kv0 = 0; kv0 < Lk; kv0 += BKV) {
    int live = 0;
    if (tid < BKV) {
      const int gr = kv0 + tid;
      live = gr < Lk && kv_mask[(int64_t)b * Lk + gr];
      kvalid[tid] = live;
    }
    // also orders the previous tile's reads of KVs and Ps before the writes
    // below
    if (!__syncthreads_or(live)) continue;  // no valid key in this tile

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

    for (int c = 0; c < NC; ++c) {
      for (int i = tid; i < BKV * DC; i += THREADS) {
        const int r = i / DC, d = i % DC;
        const int gr = kv0 + r;
        KVs[d * SK + r] =
            gr < Lk ? csn::to_f32(kp[(int64_t)gr * D + c * DC + d]) : 0.f;
      }
      __syncthreads();
      const float* Qc = Qs + c * DC * SQ;
#pragma unroll 8
      for (int d = 0; d < DC; ++d) {
        const float4 a = ld4(&Qc[d * SQ + ty * 4]);
        const float4 kk = ld4(&KVs[d * SK + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
      }
      __syncthreads();  // before the next chunk overwrites KVs
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!kvalid[tx * 4 + j]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = NEG_INF;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float scale = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * scale + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] *= scale;
    }

    if (use_drop) {  // numerator only: l and m above are undropped
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t bw[4];
        csn::dropout_words<4>(seed, (uint32_t)bh,
                              (uint32_t)(row_off + q0 + ty * 4 + i),
                              (uint32_t)(col_off + kv0 + tx * 4), bw);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = bw[j] < thresh ? s[i][j] * inv_keep : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(tx * 4 + j) * SQ + ty * 4 + i] = s[i][j];

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      for (int i = tid; i < BKV * DC; i += THREADS) {
        const int r = i / DC, d = i % DC;
        const int gr = kv0 + r;
        KVs[r * DC + d] =
            gr < Lk ? csn::to_f32(vp[(int64_t)gr * D + c * DC + d]) : 0.f;
      }
      __syncthreads();  // publishes the V chunk (and Ps, the first time)
#pragma unroll 8
      for (int kk = 0; kk < BKV; ++kk) {
        const float4 p = ld4(&Ps[kk * SQ + ty * 4]);
        const float4 vv = ld4(&KVs[kk * DC + tx * 4]);
        const float pv[4] = {p.x, p.y, p.z, p.w};
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][c * 4 + e] = fmaf(pv[i], va[e], o[i][c * 4 + e]);
      }
      __syncthreads();  // before the next chunk or tile overwrites KVs / Ps
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    if (CARRY) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        *reinterpret_cast<float4*>(acc_out + (row_base + r) * D + c * DC +
                                   tx * 4) =
            make_float4(o[i][c * 4 + 0], o[i][c * 4 + 1], o[i][c * 4 + 2],
                        o[i][c * 4 + 3]);
      if (tx == 0) {
        m_out[row_base + r] = m[i];
        l_out[row_base + r] = l[i];
      }
    } else {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          csn::store(o[i][c * 4 + e] / den,
                     out + (row_base + r) * D + c * DC + tx * 4 + e);
      if (tx == 0) lse[row_base + r] = m[i] + logf(den);
    }
  }
}

template <typename T, int D, bool CARRY>
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v,
                            const void* kv_mask, const void* q_mask, void* out,
                            void* lse, const void* m_in, const void* l_in,
                            const void* acc_in, void* m_out, void* l_out,
                            void* acc_out, int B, int H, int Lq, int Lk,
                            float inv_temp, uint64_t seed, uint32_t thresh,
                            float inv_keep, int use_drop, int row_off,
                            int col_off, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T, D, CARRY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_fwd_wide_kernel<T, D, CARRY><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<T*>(out),
      static_cast<float*>(lse), static_cast<const float*>(m_in),
      static_cast<const float*>(l_in), static_cast<const float*>(acc_in),
      static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(acc_out), H, Lq, Lk, inv_temp, seed, thresh,
      inv_keep, use_drop, row_off, col_off);
  return cudaGetLastError();
}

}  // namespace csn_wide
