// The layouts of the f32 D=64 split-TF32 attention forward
// (csrc/flash_tf32_d64_fwd.cuh), to be timed against each other by
// tools/flash_d64_designs.py. Not part of the kernel library: the shipped
// header holds one layout (Q in registers, P V over the whole head).
//
// flash_fwd_d64_design_kernel<QREG, PVN> is the shipped kernel with two
// choices opened: Q's A fragments split once and kept in registers (QREG)
// or split from the Q tile at every key tile; P V in groups of PVN 8-dim
// n-tiles (4: each half of the head in turn; 8: the whole head at once,
// one P split per tile). Every layout computes the shipped one's products
// in the same order per output element, so their outputs are bitwise
// equal. It reuses the header's helpers and shared-memory layout.

#include "flash_tf32_d64_fwd.cuh"

namespace csn_tf32_d64 {
namespace {

template <bool QREG, int PVN>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_d64_design_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const uint8_t* __restrict__ kv_mask,
                            const uint8_t* __restrict__ q_mask,
                            float* __restrict__ out, float* __restrict__ lse,
                            int H, int Lq, int Lk, float inv_temp,
                            Drop drop) {
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

  int qlive = 0;
  if (tid < TILE) {
    const int r = q0 + tid;
    qlive = r < Lq && q_mask[(int64_t)b * Lq + r];
  }
  if (!__syncthreads_or(qlive)) {  // padding tile: zeros
    for (int i = tid; i < TILE * D / 4; i += THREADS) {
      const int r = q0 + i / (D / 4);
      if (r < Lq)
        reinterpret_cast<float4*>(op + (int64_t)r * D)[i % (D / 4)] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid < TILE && q0 + tid < Lq) lp[q0 + tid] = NEG_INF + logf(1e-30f);
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
  FragA qa[QREG ? D / 8 : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) load_a(qa[ks], sm.q, r0, ks, g, t);
  }

  const float sc = inv_temp * LOG2E;  // scores in log2 units
  const float inv_keep = drop.on ? drop.inv_keep : 1.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
  zero(o);
  const uint32_t row = (uint32_t)(q0 + r0 + g);

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
    mma_abt<8>(s, [&](int ks) {
      FragA a;
      if constexpr (QREG) {
        a = qa[ks];
      } else {
        load_a(a, sm.q, r0, ks, g, t);
      }
      return a;
    }, ks_t, 0, g, t);

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
      const uint32_t kb = keep_bits(drop.seed, (uint32_t)bh, row,
                                    (uint32_t)(kt * TILE), drop.thresh, t);
#pragma unroll
      for (int n = 0; n < 8; ++n)
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
      for (int j = 0; j < 8; ++j) {  // keys 8 j .. 8 j + 7
        FragA pa;
        c_to_a(pa, s[j]);
        FragB bv[PVN];
#pragma unroll
        for (int n = 0; n < PVN; ++n)
          load_b_k(bv[n], vs_t, 8 * j, 8 * (PVN * grp + n), g, t);
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

// launch_fwd of the header in the layout (QREG, PVN)
template <bool QREG, int PVN>
cudaError_t launch_design(const void* q, const void* k, const void* v,
                          const void* kv_mask, const void* q_mask, void* out,
                          void* lse, int B, int H, int Lq, int Lk,
                          float inv_temp, const Drop& drop,
                          cudaStream_t stream) {
  constexpr int smem = (int)sizeof(FwdSmem);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_d64_design_kernel<QREG, PVN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Lq + TILE - 1) / TILE), (unsigned)(B * H));
  flash_fwd_d64_design_kernel<QREG, PVN><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const uint8_t*>(q_mask), static_cast<float*>(out),
      static_cast<float*>(lse), H, Lq, Lk, inv_temp, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csn_tf32_d64

using csn_tf32_d64::Drop;

// variant v: Q in registers (v < 2) or split per key tile (v >= 2); P V by
// 4 n-tiles (v even) or 8 (v odd, the shipped layout's)
extern "C" int csn_flash_d64_fwd_design(
    int variant, const void* q, const void* k, const void* v,
    const void* kv_mask, const void* q_mask, void* out, void* lse, int B,
    int H, int Lq, int Lk, float inv_temp, uint64_t seed, uint32_t thresh,
    float inv_keep, int use_drop, void* stream) {
  const Drop drop{seed, thresh, inv_keep, use_drop, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CSN_FWD(QREG, PVN)                                                 \
  return csn_tf32_d64::launch_design<QREG, PVN>(q, k, v, kv_mask, q_mask, \
                                                out, lse, B, H, Lq, Lk,   \
                                                inv_temp, drop, s)
  switch (variant) {
    case 0: CSN_FWD(true, 4);
    case 1: CSN_FWD(true, 8);
    case 2: CSN_FWD(false, 4);
    case 3: CSN_FWD(false, 8);
  }
#undef CSN_FWD
  return cudaErrorInvalidValue;
}
