// Sparse convolution forward over a precomputed kernel map.
//
// Replaces: csn_tpu/core/window_conv.py window_conv_fwd (Pallas bodies
// _tile_fwd_kernel and _wjobs_fwd_kernel), which the JAX package reaches
// through core/conv.py sparse_conv_tvjp.
//
// Computes out[i] = sum_k feats[kmap[k, i]] @ W[k] for i < n_out, where a
// kmap entry outside [0, n_in) (the sentinel n_in) adds nothing. Operands are
// read in the activation type (f32 or bf16), products accumulate in f32
// registers, and each output element is stored once in the activation type.
// The backward's d_feats is the same function over the transpose map with
// the paired weights transposed (core/conv.py conv_bwd_kernels).
//
// Two kinds of body, chosen by dtype and shape (as flash_attn.cu chooses by
// dtype and head dim; a failed launch of any returns its error, there is no
// retry on another; window_conv.k1_tensor_cores is the rule):
//  * Cout % 8 == 0, whatever Cin (every conv of the HRNet and U-Net
//    families, the k5 stems' Cin 3 included): the tensor-core body of
//    sparse_conv_tc.cuh, with f32 accumulators. bf16 runs mma.sync
//    m16n8k16 on bf16 operands; f32 runs mma.sync m16n8k8 on TF32 operands
//    in split TF32 (three products per f32 product, the f32 checks' 1e-4
//    of max|ref|), W split in registers as its fragments are loaded. Where
//    Cin % 16 == 0 it walks K1's steps (offset, 64 bf16 or 32 f32 input
//    channels); other Cin (the stems) take the flattened steps of K*Cin
//    (64 or 32 columns) that the im2col forward runs, so K1's bf16 stem
//    output is the im2col forward's bit for bit;
//  * Cout % 8 != 0, either type: the CUDA-core body (f32 FMAs) below.
//
// What bounds it on the H100: per output row and live offset one gathered
// row of Cin values and 2*Cin*Cout operations; the bound counts each input
// byte once (chip_smoke.py conv_work). Every body does more than that: the
// products run over every row of a tile at each offset where any of its
// rows is live (a sentinel row is zero-filled: no read, but its products
// run), and every row tile reads W[k] again (from L2: the W of one conv is
// at most a few MB). At the stem the [125, N] int32 map is most of the
// bytes; the flattened steps read it once per row tile into shared memory
// and gather the 6- or 12-byte rows element by element.
//
// Tensor-core design: sparse_conv_tc.cuh (K1's steps, FLAT false; the
// flattened steps, FLAT true; bf16 or f32), which the im2col forward
// (sparse_conv_im2col.cu) shares in bf16.
//
// CUDA-core design (Cout % 8 != 0). One block per
// tile of 64 output rows x 64 output channels. The block walks the
// offsets; per offset it stages the 64 source-row indices in shared memory
// and skips the offset when every one is a sentinel, then walks Cin in
// chunks of 16: the gathered rows (zeros for a sentinel) and the W[k]
// slice go to shared memory in f32, and each of the 256 threads
// accumulates a 4 x 4 register tile.

#include "common.cuh"
#include "sparse_conv_tc.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
sparse_conv_fwd_kernel(const T* __restrict__ feats,
                       const int32_t* __restrict__ kmap,
                       const T* __restrict__ w, T* __restrict__ out,
                       int64_t n_in, int64_t n_out, int n_off, int cin,
                       int cout) {
  __shared__ __align__(16) float As[BK][BM];  // gathered rows, channel-major
  __shared__ __align__(16) float Bs[BK][BN];  // W[k] slice
  __shared__ int64_t rows[BM];                // source row per output row

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < n_off; ++k) {
    int live = 0;
    if (tid < BM) {
      const int64_t i = m0 + tid;
      int64_t r = -1;
      if (i < n_out) {
        const int64_t v = kmap[(int64_t)k * n_out + i];
        if (v >= 0 && v < n_in) r = v;
      }
      rows[tid] = r;
      live = r >= 0;
    }
    // also the barrier that publishes rows[]
    if (!__syncthreads_or(live)) continue;

    for (int c0 = 0; c0 < cin; c0 += BK) {
      {  // A: row tid/4, channels (tid%4)*4 .. +3 of this chunk
        const int m = tid >> 2;
        const int cc = (tid & 3) * 4;
        const int64_t r = rows[m];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + cc + q;
          As[cc + q][m] =
              (r >= 0 && c < cin) ? csn::to_f32(feats[r * cin + c]) : 0.f;
        }
      }
      {  // B: channel tid/16 of this chunk, output channels (tid%16)*4 .. +3
        const int kk = tid >> 4;
        const int nn = (tid & 15) * 4;
        const int c = c0 + kk;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + nn + q;
          Bs[kk][nn + q] =
              (c < cin && n < cout)
                  ? csn::to_f32(w[((int64_t)k * cin + c) * cout + n])
                  : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + ty * 4 + i;
    if (row >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < cout) csn::store(acc[i][j], out + row * cout + col);
    }
  }
}

template <typename T>
cudaError_t launch(const void* feats, const void* kmap, const void* w,
                   void* out, int64_t n_in, int64_t n_out, int n_off, int cin,
                   int cout, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_out + BM - 1) / BM),
                  (unsigned)((cout + BN - 1) / BN));
  sparse_conv_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int32_t*>(kmap),
      static_cast<const T*>(w), static_cast<T*>(out), n_in, n_out, n_off, cin,
      cout);
  return cudaGetLastError();
}

}  // namespace

// feats [n_in, cin] and w [n_off, cin, cout] in one type, kmap [n_off,
// n_out] int32, out [n_out, cout]. The tensor-core bodies copy w, and feats
// where Cin % 16 == 0, 16 bytes at a time: those start on a 16-byte
// boundary.
extern "C" int csn_sparse_conv_fwd(int dtype, const void* feats,
                                   const void* kmap, const void* w, void* out,
                                   int64_t n_in, int64_t n_out, int n_off,
                                   int cin, int cout, void* stream) {
  if (n_out == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool flat = cin % 16 != 0;
  if (dtype == csn::kBF16 && cout % 8 == 0)
    return flat ? csn_conv_tc::launch_tc<true>(feats, kmap, w, out, n_in,
                                               n_out, n_off, cin, cout, s)
                : csn_conv_tc::launch_tc<false>(feats, kmap, w, out, n_in,
                                                n_out, n_off, cin, cout, s);
  if (dtype == csn::kF32 && cout % 8 == 0)
    return flat ? csn_conv_tc::launch_tc<true, float>(
                      feats, kmap, w, out, n_in, n_out, n_off, cin, cout, s)
                : csn_conv_tc::launch_tc<false, float>(
                      feats, kmap, w, out, n_in, n_out, n_off, cin, cout, s);
  if (dtype == csn::kF32)
    return launch<float>(feats, kmap, w, out, n_in, n_out, n_off, cin, cout, s);
  if (dtype == csn::kBF16)
    return launch<__nv_bfloat16>(feats, kmap, w, out, n_in, n_out, n_off, cin,
                                 cout, s);
  return cudaErrorInvalidValue;
}
