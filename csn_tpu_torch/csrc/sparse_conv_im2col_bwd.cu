// Sparse convolution backward in im2col form: one gather of the output
// gradient over the transpose map feeds both gradients.
//
// Replaces: csn_tpu/core/window_conv.py window_conv_bwd in the modes
// CSN_DYNG=2/3 (Pallas body _tile_bwd_im2col_kernel), which the JAX package
// reaches through the custom VJP of core/conv.py sparse_conv_tvjp.
//
// With GG[n][k*Cout + d] = g[kmap_t[k, n]][d] for n < n_in (zero where
// kmap_t[k, n] is outside [0, n_g): the sentinel n_g), computes
//   d_feats[n]  = GG[n] @ WT          WT [K*Cout, Cin], WT[k*Cout+d][c] =
//                                     W_pair[k][c][d]   (skipped if dw_only)
//   dW_flat     = feats^T @ GG        [Cin, K*Cout] f32, summed over all rows.
// Operands are read in the activation type, products accumulate in f32;
// d_feats is stored in the activation type, dW_flat in f32. The caller
// unstacks dW_flat [Cin, K, Cout] -> dW_t [K, Cin, Cout] and un-mirrors
// same-level maps.
//
// What bounds it on the H100: operations. 4*Cin*Cout flops per valid (row,
// offset), on the CUDA cores (FMA), the sum of K1 over the transpose map and
// sparse_conv_dw; what the form saves is the second gather of g.
//
// Design. The TPU grid is sequential and adds every tile's product into one
// resident dW block. Here the row tiles run in parallel, so block (split s,
// tile ct of BC input channels) owns a contiguous run of 64-row tiles and a
// private f32 partial part[s][ct*BC .. +BC][K*Cout], zeroed by the caller.
// For each of its row tiles it stages the tile's transpose-map columns and
// its feats rows in shared memory, then walks the flattened axis K*Cout in
// chunks of 64 columns: it gathers GG[:, chunk] into shared memory once, adds
// GG[:, chunk] @ WT[chunk] to the d_feats tile it keeps in registers, forms
// feats_tile^T @ GG[:, chunk] in registers and adds it to its partial in
// device memory (no other block touches that slice, so the read-modify-write
// needs no atomics and the order of the sum is fixed). A chunk whose offsets
// have no valid row in the tile is skipped. A second kernel (common.cuh) sums
// the S partials in the order s = 0, 1, ... The input channels are a grid
// dimension, so a wide conv (Cin 256) gathers each GG chunk once per tile of
// 64 channels; both products split cleanly along it. The partial costs
// BC * 64 * 8 bytes of read-modify-write per 4 * 64 * BC * 64 flops, one byte
// per 32 flops, and S is bounded by the caller so that the partials stay
// within a fixed memory budget. BC is 16 for the 3-channel stem and 64
// otherwise.

#include "common.cuh"

namespace {

constexpr int BM = 64;   // rows per tile
constexpr int BJ = 64;   // columns of the flattened axis per chunk
constexpr int THREADS = 256;

template <typename T, int MI>
__global__ void __launch_bounds__(THREADS)
im2col_bwd_kernel(const T* __restrict__ feats, const T* __restrict__ g,
                  const int32_t* __restrict__ kmap_t,
                  const T* __restrict__ wt, T* __restrict__ dfeats,
                  float* __restrict__ part, int64_t n_in, int64_t n_g,
                  int n_off, int cin, int cout, int64_t n_tiles,
                  int64_t tiles_per_split, int dw_only) {
  constexpr int BC = 16 * MI;  // input channels per block
  extern __shared__ __align__(16) unsigned char smem[];
  float* Gs = reinterpret_cast<float*>(smem);        // [BM][BJ] GG chunk
  float* Ws = Gs + BM * BJ;                          // [BJ][BC] WT chunk
  float* Fs = Ws + BJ * BC;                          // [BM][BC] feats tile
  int32_t* ks = reinterpret_cast<int32_t*>(Fs + BM * BC);  // [n_off][BM]
  int32_t* live = ks + n_off * BM;                   // [n_off]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int s = blockIdx.x;
  const int c0 = blockIdx.y * BC;
  const int64_t kj = (int64_t)n_off * cout;  // length of the flattened axis
  float* my = part + (int64_t)s * cin * kj;
  const int64_t t_begin = (int64_t)s * tiles_per_split;
  const int64_t t_end =
      t_begin + tiles_per_split < n_tiles ? t_begin + tiles_per_split : n_tiles;
  const bool vec = (kj & 3) == 0;

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t m0 = t * BM;
    for (int k = tid; k < n_off; k += THREADS) live[k] = 0;
    __syncthreads();
    for (int e = tid; e < n_off * BM; e += THREADS) {
      const int k = e / BM, m = e % BM;
      const int64_t i = m0 + m;
      int32_t r = -1;
      if (i < n_in) {
        const int32_t v = kmap_t[(int64_t)k * n_in + i];
        if (v >= 0 && v < n_g) r = v;
      }
      ks[e] = r;
      if (r >= 0) live[k] = 1;  // every writer stores the same value
    }
    for (int e = tid; e < BM * BC; e += THREADS) {
      const int r = e / BC, c = e % BC;
      const int64_t i = m0 + r;
      Fs[e] = (i < n_in && c0 + c < cin)
                  ? csn::to_f32(feats[i * cin + c0 + c])
                  : 0.f;
    }
    __syncthreads();

    // d_feats tile: rows ty*4 .. +3, input channels c0 + tx*MI .. +MI-1
    float dacc[4][MI];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < MI; ++m) dacc[i][m] = 0.f;

    for (int64_t j0 = 0; j0 < kj; j0 += BJ) {
      {  // the same for every thread: live[] is read-only here
        const int k_lo = (int)(j0 / cout);
        const int64_t j_hi = j0 + BJ - 1 < kj - 1 ? j0 + BJ - 1 : kj - 1;
        const int k_hi = (int)(j_hi / cout);
        int any = 0;
        for (int k = k_lo; k <= k_hi; ++k) any |= live[k];
        if (!any) continue;
      }
      {  // column jj = tid % BJ of rows tid / BJ, + 4, ...: the (offset,
         // channel) of the column is the same for all of a thread's rows
        const int jj = tid % BJ;
        const int64_t j = j0 + jj;
        const int k = (int)(j / cout);
        const int d = (int)(j - (int64_t)k * cout);
        for (int r = tid / BJ; r < BM; r += THREADS / BJ) {
          float v = 0.f;
          if (j < kj) {
            const int32_t gi = ks[k * BM + r];
            if (gi >= 0) v = csn::to_f32(g[(int64_t)gi * cout + d]);
          }
          Gs[r * BJ + jj] = v;
        }
      }
      if (!dw_only) {
        for (int e = tid; e < BJ * BC; e += THREADS) {
          const int jj = e / BC, c = e % BC;
          const int64_t j = j0 + jj;
          Ws[e] = (j < kj && c0 + c < cin)
                      ? csn::to_f32(wt[j * cin + c0 + c])
                      : 0.f;
        }
      }
      __syncthreads();

      if (!dw_only) {
        // four columns at a time: each row's four GG values are one 16-byte
        // load (the two rows groups of a warp read the same address)
#pragma unroll 2
        for (int j4 = 0; j4 < BJ; j4 += 4) {
          float av[4][4], bv[4][MI];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(
                &Gs[(ty * 4 + i) * BJ + j4]);
            av[i][0] = a.x;
            av[i][1] = a.y;
            av[i][2] = a.z;
            av[i][3] = a.w;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int m = 0; m < MI; ++m)
              bv[q][m] = Ws[(j4 + q) * BC + tx * MI + m];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int m = 0; m < MI; ++m)
                dacc[i][m] = fmaf(av[i][q], bv[q][m], dacc[i][m]);
        }
      }

      // dW chunk: input channels c0 + ty*MI .. +MI-1, columns j0 + tx*4 .. +3
      float wacc[MI][4];
#pragma unroll
      for (int m = 0; m < MI; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) wacc[m][q] = 0.f;
#pragma unroll 8
      for (int r = 0; r < BM; ++r) {
        float av[MI];
#pragma unroll
        for (int m = 0; m < MI; ++m) av[m] = Fs[r * BC + ty * MI + m];
        const float4 b = *reinterpret_cast<const float4*>(&Gs[r * BJ + tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int m = 0; m < MI; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wacc[m][q] = fmaf(av[m], bv[q], wacc[m][q]);
      }
#pragma unroll
      for (int m = 0; m < MI; ++m) {
        const int c = c0 + ty * MI + m;
        if (c >= cin) continue;
        float* p = my + (int64_t)c * kj + j0 + tx * 4;
        if (vec && j0 + tx * 4 + 3 < kj) {
          float4 old = *reinterpret_cast<float4*>(p);
          old.x += wacc[m][0];
          old.y += wacc[m][1];
          old.z += wacc[m][2];
          old.w += wacc[m][3];
          *reinterpret_cast<float4*>(p) = old;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (j0 + tx * 4 + q < kj) p[q] += wacc[m][q];
        }
      }
      __syncthreads();  // Gs and Ws are rewritten by the next chunk
    }

    if (!dw_only) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t row = m0 + ty * 4 + i;
        if (row >= n_in) continue;
#pragma unroll
        for (int m = 0; m < MI; ++m) {
          const int c = c0 + tx * MI + m;
          if (c < cin) csn::store(dacc[i][m], dfeats + row * cin + c);
        }
      }
    }
    __syncthreads();  // ks, live and Fs are rewritten by the next tile
  }
}

template <int MI>
size_t smem_bytes(int n_off) {
  constexpr int BC = 16 * MI;
  return (size_t)(BM * BJ + BJ * BC + BM * BC) * sizeof(float) +
         (size_t)n_off * (BM + 1) * sizeof(int32_t);
}

template <typename T, int MI>
cudaError_t launch(const void* feats, const void* g, const void* kmap_t,
                   const void* wt, void* dfeats, void* part, void* out,
                   int64_t n_in, int64_t n_g, int n_off, int cin, int cout,
                   int n_split, int dw_only, cudaStream_t stream) {
  constexpr int BC = 16 * MI;
  const size_t bytes = smem_bytes<MI>(n_off);
  cudaError_t err = cudaFuncSetAttribute(
      im2col_bwd_kernel<T, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = (n_in + BM - 1) / BM;
  const int64_t tiles_per_split = (n_tiles + n_split - 1) / n_split;
  const dim3 grid((unsigned)n_split, (unsigned)((cin + BC - 1) / BC));
  // one split accumulates straight into the (zeroed) result
  float* dst = static_cast<float*>(n_split == 1 ? out : part);
  im2col_bwd_kernel<T, MI><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(g),
      static_cast<const int32_t*>(kmap_t), static_cast<const T*>(wt),
      static_cast<T*>(dfeats), dst, n_in, n_g, n_off, cin, cout, n_tiles,
      tiles_per_split, dw_only);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int64_t n = (int64_t)cin * n_off * cout;
  csn::sum_splits_kernel<THREADS>
      <<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          static_cast<const float*>(part), static_cast<float*>(out), n,
          n_split);
  return cudaGetLastError();
}

}  // namespace

// feats [n_in, cin], g [n_g, cout] and wt [n_off * cout, cin] of one type,
// kmap_t [n_off, n_in] int32 (sentinel n_g); dfeats [n_in, cin] of that type
// (unused with dw_only); part [n_split, cin, n_off * cout] f32 zeroed by the
// caller (unused when n_split == 1, and then out must be zeroed); out
// [cin, n_off * cout] f32.
extern "C" int csn_sparse_conv_im2col_bwd(int dtype, const void* feats,
                                          const void* g, const void* kmap_t,
                                          const void* wt, void* dfeats,
                                          void* part, void* out, int64_t n_in,
                                          int64_t n_g, int n_off, int cin,
                                          int cout, int n_split, int dw_only,
                                          void* stream) {
  if (n_in == 0 || n_off == 0 || cin == 0 || cout == 0) return cudaSuccess;
  if (n_split < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = cin <= 16;
  if (dtype == csn::kF32)
    return narrow ? launch<float, 1>(feats, g, kmap_t, wt, dfeats, part, out,
                                     n_in, n_g, n_off, cin, cout, n_split,
                                     dw_only, s)
                  : launch<float, 4>(feats, g, kmap_t, wt, dfeats, part, out,
                                     n_in, n_g, n_off, cin, cout, n_split,
                                     dw_only, s);
  if (dtype == csn::kBF16)
    return narrow ? launch<__nv_bfloat16, 1>(feats, g, kmap_t, wt, dfeats,
                                             part, out, n_in, n_g, n_off, cin,
                                             cout, n_split, dw_only, s)
                  : launch<__nv_bfloat16, 4>(feats, g, kmap_t, wt, dfeats,
                                             part, out, n_in, n_g, n_off, cin,
                                             cout, n_split, dw_only, s);
  return cudaErrorInvalidValue;
}
