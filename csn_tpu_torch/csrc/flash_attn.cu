// Masked flash attention forward (online softmax), with the log-sum-exp rows.
//
// Replaces: csn_tpu/ops/flash.py _flash_forward (Pallas body _fwd_kernel),
// which the JAX package reaches through flash_attention from
// ops/attention.py MultiHeadAttention.
//
// Computes, per (batch*head, query row) with valid keys j (kv_mask true):
//   s_j = (q / temperature) . k_j,  out = sum_j softmax(s)_j v_j,
//   lse = max_j s_j + log(sum_j exp(s_j - max)),
// with masked keys at NEG_INF = -1e30, the denominator floored at 1e-30,
// f32 arithmetic throughout, out stored in the activation type and lse in
// f32. A query tile with no valid query is skipped and written as zeros (its
// rows are padding, which callers mask), and so is a key tile with no valid
// key (it would add nothing). Only rows whose q_mask is true are part of the
// contract, as in the TPU kernel.
//
// Attention-weight dropout (rate 1 - keep, torch's dropout(softmax(s)) @ v)
// follows the TPU kernel's flash identity (flash.py:144-150): the numerator
// takes m_ij * p_ij / keep, the denominator and lse stay undropped. The mask
// m_ij comes from csn::dropout_bits, keyed by (seed, batch*head, query row,
// key column), so the backward kernels (flash_attn_bwd.cu) and the plain
// version regenerate exactly the same entries.
//
// What bounds it on the H100: 4*Lq*Lk*D flops against (Lq + 2*Lk)*D reads
// per (batch, head): at Lq = Lk = 5632 and D = 64 it is compute-bound. This
// first version runs both products on the CUDA cores in f32 (FMA); the
// tensor-core (wgmma) form is later work.
//
// Design: one block of 256 threads per (batch*head, tile of 64 queries). The
// block keeps the scaled query tile in shared memory and walks the keys in
// tiles of 64: K (transposed) and V go to shared memory, each thread computes
// a 4 x 4 tile of scores, the running max and denominator of its 4 rows are
// reduced across the 16 threads that share those rows with warp shuffles,
// the probabilities go to shared memory, and each thread accumulates a
// 4 x D/16 tile of the output in registers, rescaled as the max moves. No
// [Lq, Lk] matrix reaches device memory. The TPU kernel's sequential kv grid
// axis with VMEM scratch becomes this loop inside the block.
//
// Wide heads (D = 128, 256: the MID-FC heads use 256 per head) take the
// kernel of flash_wide.cuh, which keeps only the query tile whole in shared
// memory and walks D in chunks of 64; the D = 64 kernel below is unchanged.

#include "common.cuh"
#include "flash_wide.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 rows, tx 4 keys / D/16 dims
constexpr int PAD = 4;        // row padding of the transposed tiles (banks)
constexpr int SQ = BQ + PAD;  // stride of Qs and Ps
constexpr int SK = BKV + PAD; // stride of Ks
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)D * SQ + (size_t)D * SK + (size_t)BKV * D +
                          (size_t)BKV * SQ) +
         sizeof(int) * BKV;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 const uint8_t* __restrict__ q_mask, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Lq, int Lk,
                 float inv_temp, uint64_t seed, uint32_t thresh,
                 float inv_keep, int use_drop) {
  constexpr int CPT = D / 16;  // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [D][SQ]  scaled queries, transposed
  float* Ks = Qs + D * SQ;      // [D][SK]  keys, transposed
  float* Vs = Ks + D * SK;      // [BKV][D]
  float* Ps = Vs + BKV * D;     // [BKV][SQ] probabilities, transposed
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
  T* op = out + (int64_t)bh * Lq * D;
  float* lp = lse + (int64_t)bh * Lq;

  int qlive = 0;
  if (tid < BQ) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = q0 + i / D;
      if (r < Lq) csn::store(0.f, op + (int64_t)r * D + i % D);
    }
    if (tid < BQ && q0 + tid < Lq) lp[q0 + tid] = NEG_INF + logf(1e-30f);
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
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < Lk; kv0 += BKV) {
    int live = 0;
    if (tid < BKV) {
      const int gr = kv0 + tid;
      live = gr < Lk && kv_mask[(int64_t)b * Lk + gr];
      kvalid[tid] = live;
    }
    if (!__syncthreads_or(live)) continue;  // no valid key in this tile

    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int gr = kv0 + r;
      const bool ok = gr < Lk;
      Ks[d * SK + r] = ok ? csn::to_f32(kp[(int64_t)gr * D + d]) : 0.f;
      Vs[r * D + d] = ok ? csn::to_f32(vp[(int64_t)gr * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * SQ + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&Ks[d * SK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
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
        const csn::U4 bits = csn::dropout_bits(
            seed, (uint32_t)bh, (uint32_t)(q0 + ty * 4 + i),
            (uint32_t)((kv0 + tx * 4) >> 2));
        const uint32_t bw[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = bw[j] < thresh ? s[i][j] * inv_keep : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(tx * 4 + j) * SQ + ty * 4 + i] = s[i][j];
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[kk * SQ + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * D + tx * CPT + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
    __syncthreads();  // before the next tile overwrites Ks, Vs, Ps, kvalid
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      csn::store(o[i][c] / den, op + (int64_t)r * D + tx * CPT + c);
    if (tx == 0) lp[r] = m[i] + logf(den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, const void* q_mask, void* out,
                   void* lse, int B, int H, int Lq, int Lk, float inv_temp,
                   uint64_t seed, uint32_t thresh, float inv_keep, int use_drop,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<T*>(out),
      static_cast<float*>(lse), H, Lq, Lk, inv_temp, seed, thresh, inv_keep,
      use_drop);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, H, L, D] contiguous; kv_mask [B, Lk], q_mask [B, Lq]
// bool bytes; lse [B, H, Lq] f32. D (dk == dv) is 64 (the HRNet heads), 128
// or 256 (the MID-FC heads).
// use_drop != 0 applies dropout with keep threshold `thresh` (of 2^32) and
// scale inv_keep = 1/keep, keyed by `seed`.
extern "C" int csn_flash_attn_fwd(int dtype, const void* q, const void* k,
                                  const void* v, const void* kv_mask,
                                  const void* q_mask, void* out, void* lse,
                                  int B, int H, int Lq, int Lk, int D,
                                  float inv_temp, uint64_t seed,
                                  uint32_t thresh, float inv_keep,
                                  int use_drop, void* stream) {
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 || D == 256) {
#define CSN_WIDE(T, DD)                                                       \
  return csn_wide::launch_fwd_wide<T, DD, false>(                             \
      q, k, v, kv_mask, q_mask, out, lse, nullptr, nullptr, nullptr, nullptr, \
      nullptr, nullptr, B, H, Lq, Lk, inv_temp, seed, thresh, inv_keep,       \
      use_drop, 0, 0, s)
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
  if (dtype == csn::kF32)
    return launch<float, 64>(q, k, v, kv_mask, q_mask, out, lse, B, H, Lq, Lk,
                             inv_temp, seed, thresh, inv_keep, use_drop, s);
  if (dtype == csn::kBF16)
    return launch<__nv_bfloat16, 64>(q, k, v, kv_mask, q_mask, out, lse, B, H,
                                     Lq, Lk, inv_temp, seed, thresh, inv_keep,
                                     use_drop, s);
  return cudaErrorInvalidValue;
}
