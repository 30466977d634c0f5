// Sparse convolution forward in im2col form: one product per output tile
// over the flattened contraction axis K*Cin.
//
// Replaces: csn_tpu/core/window_conv.py window_conv_fwd in the modes
// CSN_DYNG=2/3 (Pallas body _tile_fwd_im2col_kernel), which the JAX package
// reaches through core/conv.py sparse_conv_tvjp.
//
// Computes out[i] = IC[i] @ Wflat for i < n_out, where
//   IC[i][k*Cin + c] = feats[kmap[k, i]][c]   (zero where kmap[k, i] is
//                                              outside [0, n_in): the sentinel)
//   Wflat = W.reshape(K*Cin, Cout),
// the same function as sparse_conv.cu (K1). Operands are read in the
// activation type (f32 or bf16), products accumulate in f32 registers, and
// each output element is stored once in the activation type.
//
// Two bodies, chosen by dtype and shape (window_conv.im2col_tensor_cores is
// the same rule, K1's; a failed launch returns its error, there is no retry
// on the other body):
//  * bf16, or f32 in split TF32, with Cout % 8 == 0, any Cin (every conv of
//    the HRNet, Res16UNet, ResUNet and ResNet families, the k5 stem
//    included): K1's tensor-core body of sparse_conv_tc.cuh through K1's
//    launcher, mma.sync m16n8k16 on bf16 operands, or m16n8k8 on TF32
//    operands with three products per f32 product, f32 accumulators. Where
//    Cin % 16 == 0 a walk of the flattened axis in steps of 128 bytes of a
//    row (64 bf16 or 32 f32 columns) is K1's walk over (offset, chunk of
//    input channels), so it runs K1's loop (FLAT false). Other Cin (the
//    stem's 3) take its flattened steps (FLAT true): 64 (bf16) or 32 (f32)
//    columns of K*Cin that span offsets, gathered element by element; K1
//    runs the same steps there. So the two forms agree bit for bit at every
//    conv in both types;
//  * Cout % 8 != 0, either type: the CUDA-core body below, f32 FMAs.
//
// What bounds it on the H100: the same bytes and 2*Cin*Cout operations per
// valid (row, offset) as K1 (chip_smoke.py conv_work). Both bodies run the
// products over every row of a tile at each step that holds a live offset.
//
// CUDA-core design: the IC tile of 64 rows does not fit in shared memory (64
// x 6912 bf16 = 885 KB at 256 channels against 227 KB), so the block walks
// the flattened axis in chunks of BK columns: it gathers IC[:, chunk]
// through the tile's kernel-map columns (staged once in shared memory, K x
// 64 int32), loads the matching BK rows of Wflat, and each of the 256
// threads accumulates a 4 x 4 register tile. A chunk whose offsets have no
// valid row in the tile (padding rows, offsets without neighbours) is
// skipped. The TPU kernel's windows, DMA double buffer, job table and
// 128-lane blocks per offset are not carried over.

#include "common.cuh"
#include "sparse_conv_tc.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
im2col_fwd_kernel(const T* __restrict__ feats,
                  const int32_t* __restrict__ kmap,
                  const T* __restrict__ w, T* __restrict__ out, int64_t n_in,
                  int64_t n_out, int n_off, int cin, int cout) {
  __shared__ __align__(16) float As[BK][BM];  // IC chunk, column-major
  __shared__ __align__(16) float Bs[BK][BN];  // Wflat rows of the chunk
  extern __shared__ int32_t dyn[];
  int32_t* ks = dyn;                  // [n_off][BM] source row or -1
  int32_t* live = dyn + n_off * BM;   // [n_off] any valid row in the tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kc = n_off * cin;  // length of the flattened axis

  for (int k = tid; k < n_off; k += THREADS) live[k] = 0;
  __syncthreads();
  for (int e = tid; e < n_off * BM; e += THREADS) {
    const int k = e / BM, m = e % BM;
    const int64_t i = m0 + m;
    int32_t r = -1;
    if (i < n_out) {
      const int32_t v = kmap[(int64_t)k * n_out + i];
      if (v >= 0 && v < n_in) r = v;
    }
    ks[e] = r;
    if (r >= 0) live[k] = 1;  // every writer stores the same value
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < kc; j0 += BK) {
    {  // the same for every thread: live[] is read-only here
      const int k_lo = j0 / cin;
      const int j_hi = j0 + BK - 1 < kc - 1 ? j0 + BK - 1 : kc - 1;
      const int k_hi = j_hi / cin;
      int any = 0;
      for (int k = k_lo; k <= k_hi; ++k) any |= live[k];
      if (!any) continue;
    }
    {  // A: row tid/4, columns j0 + (tid%4)*4 .. +3 of the flattened axis
      const int m = tid >> 2;
      const int cc = (tid & 3) * 4;
      // (offset, channel) of column j0 + cc, stepped from there: one
      // division per thread and chunk, none per element
      int k = (j0 + cc) / cin;
      int c = j0 + cc - k * cin;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = 0.f;
        if (j0 + cc + q < kc) {
          const int32_t r = ks[k * BM + m];
          if (r >= 0) v = csn::to_f32(feats[(int64_t)r * cin + c]);
        }
        As[cc + q][m] = v;
        if (++c == cin) {
          c = 0;
          ++k;
        }
      }
    }
    {  // B: row j0 + tid/16 of Wflat, output channels (tid%16)*4 .. +3
      const int kk = tid >> 4;
      const int nn = (tid & 15) * 4;
      const int j = j0 + kk;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + nn + q;
        Bs[kk][nn + q] = (j < kc && n < cout)
                             ? csn::to_f32(w[(int64_t)j * cout + n])
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
  const size_t dyn_bytes = (size_t)n_off * (BM + 1) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      im2col_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n_out + BM - 1) / BM),
                  (unsigned)((cout + BN - 1) / BN));
  im2col_fwd_kernel<T><<<grid, THREADS, dyn_bytes, stream>>>(
      static_cast<const T*>(feats), static_cast<const int32_t*>(kmap),
      static_cast<const T*>(w), static_cast<T*>(out), n_in, n_out, n_off, cin,
      cout);
  return cudaGetLastError();
}

}  // namespace

// feats [n_in, cin], kmap [n_off, n_out] int32 (sentinel n_in), w
// [n_off * cin, cout] of the feats' type, out [n_out, cout]. The
// tensor-core bodies copy w, and feats where Cin % 16 == 0, 16 bytes at a
// time: those start on a 16-byte boundary.
extern "C" int csn_sparse_conv_im2col_fwd(int dtype, const void* feats,
                                          const void* kmap, const void* w,
                                          void* out, int64_t n_in,
                                          int64_t n_out, int n_off, int cin,
                                          int cout, void* stream) {
  if (n_out == 0 || cout == 0) return cudaSuccess;
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
