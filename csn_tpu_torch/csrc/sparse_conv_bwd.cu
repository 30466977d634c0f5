// Sparse convolution backward, weight gradient: dW_t[k] = feats^T . gather(g,
// kmap_t[k]) in f32.
//
// Replaces: the dW half of csn_tpu/core/window_conv.py window_conv_bwd
// (Pallas body _tile_bwd_kernel / _wjobs_bwd_kernel), which the JAX package
// reaches through the custom VJP of core/conv.py sparse_conv_tvjp. The other
// half, d_feats = sum_k gather(g, kmap_t[k]) . W_pair[k]^T, is a forward
// sparse conv over the transpose map and runs on the forward kernel
// (sparse_conv.cu) with the weights transposed.
//
// Computes, for offset k of the transpose map kmap_t [K, n_in] (entries
// outside [0, n_g), the sentinel n_g, add nothing):
//   dW_t[k][c][d] = sum_{n < n_in} feats[n][c] * g[kmap_t[k][n]][d],
// the identity of csn_tpu/core/conv.py:159-164 (each offset map is a partial
// permutation, so the forward's scatter of feats^T . g becomes this gather).
// Operands are read in the activation type, products accumulate in f32, and
// dW_t is stored in f32. The caller un-mirrors same-level maps (dW = dW_t
// reversed over k).
//
// What bounds it on the H100: the same 2*Cin*Cout flops per (row, offset)
// as the forward, on the CUDA cores (FMA); it is a reduction over up to
// 90112 rows per offset into a small [Cin, Cout] tile, so the level-0 convs
// (K tiles of 64x64) would leave most of the 132 SMs idle without a split of
// the rows.
//
// Design: deterministic split-N with no atomics. Block (tile of TM input
// channels x 64 output channels, offset k, split s) walks its share of the
// rows in chunks of 16: it stages the chunk's kmap_t entries, skips the
// chunk when all are sentinels (padding rows, offsets without neighbours),
// loads the feats rows and the gathered g rows into shared memory, and each
// of the 256 threads accumulates a (TM/16) x 4 register tile. The block
// stores its partial [TM, 64] tile once; a second small kernel (common.cuh)
// sums the S partials [S, K, Cin, Cout] in a fixed order. The caller picks S
// so that the grid holds at least about two blocks per SM. TM is 16 for the
// 3-channel stem (so 3 of 16 rows of the tile, not 3 of 64, are padding) and
// 64 otherwise. The TPU kernel fused d_feats into the same pass over its
// VMEM windows; here d_feats, an output-stationary conv, and dW, an
// offset-stationary reduction, want different block shapes.

#include "common.cuh"

namespace {

constexpr int BN = 64;   // output channels per tile
constexpr int BR = 16;   // rows per chunk
constexpr int THREADS = 256;

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
sparse_conv_dw_kernel(const T* __restrict__ feats, const T* __restrict__ g,
                      const int32_t* __restrict__ kmap_t,
                      float* __restrict__ part, int64_t n_in, int64_t n_g,
                      int n_off, int cin, int cout, int64_t rows_per_split) {
  constexpr int MI = TM / 16;  // input channels per thread
  __shared__ __align__(16) float As[BR][TM];  // feats rows
  __shared__ __align__(16) float Bs[BR][BN];  // gathered g rows
  __shared__ int64_t grow[BR];                // g row per feats row, or -1

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // input channels ty*MI .. ty*MI+MI-1
  const int n_tiles = (cout + BN - 1) / BN;
  const int c0 = (blockIdx.x / n_tiles) * TM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int k = blockIdx.y;
  const int s = blockIdx.z;
  const int64_t r_begin = (int64_t)s * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < n_in ? r_begin + rows_per_split : n_in;
  const int32_t* km = kmap_t + (int64_t)k * n_in;

  float acc[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += BR) {
    int live = 0;
    if (tid < BR) {
      const int64_t r = r0 + tid;
      int64_t gi = -1;
      if (r < r_end) {
        const int64_t v = km[r];
        if (v >= 0 && v < n_g) gi = v;
      }
      grow[tid] = gi;
      live = gi >= 0;
    }
    // also the barrier that publishes grow[] and orders the previous
    // chunk's reads of As/Bs before these writes
    if (!__syncthreads_or(live)) continue;

    for (int e = tid; e < BR * TM; e += THREADS) {
      const int r = e / TM, m = e % TM;
      const int c = c0 + m;
      As[r][m] = (grow[r] >= 0 && c < cin)
                     ? csn::to_f32(feats[(r0 + r) * cin + c])
                     : 0.f;
    }
    for (int e = tid; e < BR * BN; e += THREADS) {
      const int r = e / BN, nn = e % BN;
      const int n = n0 + nn;
      const int64_t gi = grow[r];
      Bs[r][nn] = (gi >= 0 && n < cout) ? csn::to_f32(g[gi * cout + n]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < BR; ++r) {
      float av[MI];
      if constexpr (MI == 4) {
        const float4 a = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
        av[0] = a.x;
        av[1] = a.y;
        av[2] = a.z;
        av[3] = a.w;
      } else {
#pragma unroll
        for (int i = 0; i < MI; ++i) av[i] = As[r][ty * MI + i];
      }
      const float4 b = *reinterpret_cast<const float4*>(&Bs[r][tx * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* out = part + ((int64_t)s * n_off + k) * cin * cout;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int c = c0 + ty * MI + i;
    if (c >= cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < cout) out[(int64_t)c * cout + n] = acc[i][j];
    }
  }
}

template <typename T, int TM>
cudaError_t launch(const void* feats, const void* g, const void* kmap_t,
                   void* part, void* out, int64_t n_in, int64_t n_g,
                   int n_off, int cin, int cout, int n_split,
                   cudaStream_t stream) {
  const int64_t rows_per_split = (n_in + n_split - 1) / n_split;
  const unsigned tiles =
      (unsigned)(((cin + TM - 1) / TM) * ((cout + BN - 1) / BN));
  const dim3 grid(tiles, (unsigned)n_off, (unsigned)n_split);
  // one split writes the result directly
  float* dst = static_cast<float*>(n_split == 1 ? out : part);
  sparse_conv_dw_kernel<T, TM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(g),
      static_cast<const int32_t*>(kmap_t), dst, n_in, n_g, n_off, cin, cout,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int64_t n = (int64_t)n_off * cin * cout;
  csn::sum_splits_kernel<THREADS>
      <<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          static_cast<const float*>(part), static_cast<float*>(out), n,
          n_split);
  return cudaGetLastError();
}

}  // namespace

// feats [n_in, cin] and g [n_g, cout] of one type, kmap_t [n_off, n_in]
// int32 (sentinel n_g), part [n_split, n_off, cin, cout] f32 scratch (unused
// when n_split == 1), out [n_off, cin, cout] f32.
extern "C" int csn_sparse_conv_dw(int dtype, const void* feats, const void* g,
                                  const void* kmap_t, void* part, void* out,
                                  int64_t n_in, int64_t n_g, int n_off,
                                  int cin, int cout, int n_split,
                                  void* stream) {
  if (n_off == 0 || cin == 0 || cout == 0) return cudaSuccess;
  if (n_split < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = cin <= 16;
  if (dtype == csn::kF32)
    return narrow ? launch<float, 16>(feats, g, kmap_t, part, out, n_in, n_g,
                                      n_off, cin, cout, n_split, s)
                  : launch<float, 64>(feats, g, kmap_t, part, out, n_in, n_g,
                                      n_off, cin, cout, n_split, s);
  if (dtype == csn::kBF16)
    return narrow ? launch<__nv_bfloat16, 16>(feats, g, kmap_t, part, out,
                                              n_in, n_g, n_off, cin, cout,
                                              n_split, s)
                  : launch<__nv_bfloat16, 64>(feats, g, kmap_t, part, out,
                                              n_in, n_g, n_off, cin, cout,
                                              n_split, s);
  return cudaErrorInvalidValue;
}
