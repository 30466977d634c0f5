// Shared helpers for the port's CUDA kernels: activation-type conversion
// through the bf16 intrinsics, the dtype codes the ctypes launchers take, the
// fixed-order sum over split partials, the counter-based generator of the
// attention dropout and the arguments that the attention bodies share (the
// dropout of a launch, the ring's online-softmax carry).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace csn {

// dtype codes passed from Python (csn_tpu_torch/kernels.py DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// out[e] = sum_{s < n_split} part[s][e], in the order s = 0, 1, ...: the
// second pass of the reductions that split their rows over blocks and keep
// one f32 partial per split (no atomics, one fixed order of the sum).
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int64_t n, int n_split) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int s = 0; s < n_split; ++s) acc += part[(int64_t)s * n + e];
  out[e] = acc;
}

// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants). The torch
// twin is csn_tpu_torch/ops/flash.py `philox4x32`: the two are bit-identical,
// so a kernel and its plain version drop exactly the same entries.
struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox4x32(U4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// The attention-dropout bits of keys col4*4 .. col4*4+3 for one query row of
// one (batch*head): counter (col4, row, bh, 0), key (seed lo, seed hi), word
// j for key col4*4+j. A function of absolute positions only, so any tiling
// of the forward or the backward regenerates the same mask. Key j is kept
// when its word is < thresh = floor(keep * 2^32).
__device__ __forceinline__ U4 dropout_bits(uint64_t seed, uint32_t bh,
                                           uint32_t row, uint32_t col4) {
  return philox4x32(U4{col4, row, bh, 0u}, (uint32_t)seed,
                    (uint32_t)(seed >> 32));
}

// The dropout words of the N <= 4 consecutive key columns c0 .. c0 + N - 1 of
// one query row, for any alignment of c0 (a ring hop's key block may start at
// a column that is no multiple of 4): column c takes word c % 4 of group
// c / 4, so the run touches one group, or two when it crosses a boundary.
template <int N>
__device__ __forceinline__ void dropout_words(uint64_t seed, uint32_t bh,
                                              uint32_t row, uint32_t c0,
                                              uint32_t (&w)[N]) {
  static_assert(N >= 1 && N <= 4, "at most one group boundary");
  const uint32_t a = c0 & 3u;
  const U4 g0 = dropout_bits(seed, bh, row, c0 >> 2);
  U4 g1 = g0;
  if (a + N > 4) g1 = dropout_bits(seed, bh, row, (c0 >> 2) + 1u);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t pos = a + j;
    const U4& g = pos < 4 ? g0 : g1;
    const uint32_t k = pos & 3u;
    w[j] = k == 0 ? g.x : k == 1 ? g.y : k == 2 ? g.z : g.w;
  }
}

// The attention dropout of one launch: the seed, the keep threshold (of
// 2^32), the numerator's scale 1 / keep, whether it is on, and the place of
// the launch's query rows and key columns in the global score matrix (0 for
// K2 and its backward; a ring hop's block in flash_attn_carry.cu and
// flash_attn_block_bwd.cu)
struct Drop {
  uint64_t seed;
  uint32_t thresh;
  float inv_keep;
  int on;
  int row_off;
  int col_off;
};

// The online-softmax state of a carry launch (flash_attn_carry.cu, the
// ring's per-hop forward): m, l [B, H, Lq] and acc [B, H, Lq, D] f32, in and
// out (distinct buffers)
struct Carry {
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
};

// Rows q0 .. q0 + ROWS - 1 (those below Lq) of a carry at head dim TD, in ->
// out unchanged, by the NTHREADS threads of a block: the carry forms' query
// tile with no valid row. row_base = (batch*head) * Lq.
template <int TD, int ROWS, int NTHREADS>
__device__ __forceinline__ void carry_through(const Carry& cy,
                                              int64_t row_base, int q0,
                                              int Lq, int tid) {
  for (int i = tid; i < ROWS * TD / 4; i += NTHREADS) {
    const int r = q0 + i / (TD / 4);
    if (r < Lq) {
      const int64_t o = (row_base + r) * (TD / 4) + i % (TD / 4);
      reinterpret_cast<float4*>(cy.acc_out)[o] =
          reinterpret_cast<const float4*>(cy.acc_in)[o];
    }
  }
  if (tid < ROWS && q0 + tid < Lq) {
    cy.m_out[row_base + q0 + tid] = cy.m_in[row_base + q0 + tid];
    cy.l_out[row_base + q0 + tid] = cy.l_in[row_base + q0 + tid];
  }
}

}  // namespace csn
