// Gather probes: rows taken from a window staged in shared memory, from
// device memory / L2, or by a one-hot product.
//
// Replaces: the Pallas probe kernels of scripts/probe_dyngather.py (k_take,
// k_take_along, k_take_along_t and _timing_kernel) and of
// scripts/probe_dyngather2.py (k_matched_sublane, k_matched_lane and
// _timing_kernel). On the TPU they asked whether a kernel can gather rows
// from a window in fast memory or must multiply by a one-hot matrix; the
// answer shaped the conv kernels of csn_tpu/core/window_conv.py. On this card
// the same question decides where the conv kernels' gather stage should read
// from: K1 and the im2col kernels gather straight from device memory / L2.
//
// csn_probe_window_gather: out[i, :] = win[rel[i], :] for i < T, win [W, C],
// rel int32 in [0, W) (a row id outside the window gives a zero row). One
// block stages the whole window in dynamic shared memory and gathers from it.
// layout 0 keeps the window as [W, C]: neighbouring threads read neighbouring
// channels of one row (no bank conflicts). layout 1 stages the window
// transposed, [C, W], and gathers along the fast axis (the probe scripts'
// take_along_axis on the lane dimension): neighbouring threads then read
// addresses W words apart, and with W a multiple of 32 all 32 threads of a
// warp hit one bank (a 32-way conflict; a row pitch of W + 1 words would
// spread them over the 32 banks). The unpadded form is kept: it is the form
// the probe asks about. The matched form of probe_dyngather2.py is this
// kernel called with T = W and padded indices.
//
// csn_probe_gather_accum: for tile t < n_tiles and i < T,
//   out[t*T + i, :] = sum_{k < K} valid(r) * win[r, :], r = rows[t*K + k, i],
// rows int32 [n_tiles*K, T], out f32 [n_tiles*T, C], valid(r) = 0 <= r < W.
// One block per tile; a thread owns one channel of 8 consecutive rows.
//   mode 0 "onehot": acc += onehot[T, W] @ win, the TPU's production form,
//     computed on the CUDA cores from the window in shared memory: W times
//     the gather's operations, the price the TPU design paid;
//   mode 1 "smem": the window staged in shared memory once per block, rows
//     gathered from it;
//   mode 2 "global": rows gathered straight from device memory (the window,
//     at most 196 KB, stays in L1 / L2), as K1 does today.
//
// What bounds it on the H100: bytes. The gather modes read the row ids once
// and write the f32 output once (46.1 MB + 3.2 MB at 352 tiles x 9 offsets x
// 256 rows x 128 channels); the one-hot mode is bound by operations
// (2*T*W*C per tile and offset on the f32 CUDA cores). The shared-memory
// window of 384 x 128 f32 is 196 608 bytes, so one block fits on an SM; the
// bf16 window is half of that and two blocks fit.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 8;  // rows of one channel a thread accumulates

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_gather_kernel(const T* __restrict__ win, const int32_t* __restrict__ rel,
                     T* __restrict__ out, int W, int n_rows, int C,
                     int layout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int n = W * C;
  if (layout == 0) {
    for (int e = tid; e < n; e += THREADS) ws[e] = win[e];
  } else {
    // staged transposed: ws[c * W + w] = win[w * C + c]
    for (int e = tid; e < n; e += THREADS) {
      const int w = e / C, c = e - w * C;
      ws[c * W + w] = win[e];
    }
  }
  __syncthreads();
  const int total = n_rows * C;
  for (int e = tid; e < total; e += THREADS) {
    const int i = e / C, c = e - i * C;
    const int32_t r = rel[i];
    const bool ok = r >= 0 && r < W;
    T v = ws[0];
    if (ok) v = layout == 0 ? ws[r * C + c] : ws[c * W + r];
    csn::store(ok ? csn::to_f32(v) : 0.f, out + e);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
gather_accum_kernel(const int32_t* __restrict__ rows, const T* __restrict__ win,
                    float* __restrict__ out, int K, int W, int n_rows, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int64_t t = blockIdx.x;
  if (MODE != 2) {
    for (int e = tid; e < W * C; e += THREADS) ws[e] = win[e];
    __syncthreads();
  }
  const T* src = MODE == 2 ? win : ws;
  const int32_t* my_rows = rows + t * K * n_rows;
  const int groups = n_rows / ROWS;
  for (int e = tid; e < groups * C; e += THREADS) {
    const int ib = e / C, c = e - ib * C;
    float acc[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) acc[j] = 0.f;
    for (int k = 0; k < K; ++k) {
      int32_t r[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) r[j] = my_rows[k * n_rows + ib * ROWS + j];
      if (MODE == 0) {
        // the one-hot product: every window row meets every output row
        for (int w = 0; w < W; ++w) {
          const float v = csn::to_f32(src[w * C + c]);
#pragma unroll
          for (int j = 0; j < ROWS; ++j)
            acc[j] = fmaf(r[j] == w ? 1.f : 0.f, v, acc[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
          if (r[j] >= 0 && r[j] < W) acc[j] += csn::to_f32(src[r[j] * C + c]);
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      out[(t * n_rows + ib * ROWS + j) * C + c] = acc[j];
  }
}

template <typename T>
cudaError_t launch_window(const void* win, const void* rel, void* out, int W,
                          int n_rows, int C, int layout, cudaStream_t stream) {
  const size_t bytes = (size_t)W * C * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      window_gather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  window_gather_kernel<T><<<1, THREADS, bytes, stream>>>(
      static_cast<const T*>(win), static_cast<const int32_t*>(rel),
      static_cast<T*>(out), W, n_rows, C, layout);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_accum(const void* rows, const void* win, void* out,
                         int n_tiles, int K, int W, int n_rows, int C,
                         cudaStream_t stream) {
  const size_t bytes = MODE == 2 ? 0 : (size_t)W * C * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gather_accum_kernel<T, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  gather_accum_kernel<T, MODE><<<(unsigned)n_tiles, THREADS, bytes, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const T*>(win),
      static_cast<float*>(out), K, W, n_rows, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_accum_mode(int mode, const void* rows, const void* win,
                              void* out, int n_tiles, int K, int W, int n_rows,
                              int C, cudaStream_t s) {
  if (mode == 0)
    return launch_accum<T, 0>(rows, win, out, n_tiles, K, W, n_rows, C, s);
  if (mode == 1)
    return launch_accum<T, 1>(rows, win, out, n_tiles, K, W, n_rows, C, s);
  if (mode == 2)
    return launch_accum<T, 2>(rows, win, out, n_tiles, K, W, n_rows, C, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// win [W, C] and out [T, C] of one type (f32 or bf16), rel [T] int32.
extern "C" int csn_probe_window_gather(int dtype, int layout, const void* win,
                                       const void* rel, void* out, int W,
                                       int T, int C, void* stream) {
  if (T == 0 || C == 0) return cudaSuccess;
  if (W < 1 || (layout != 0 && layout != 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csn::kF32)
    return launch_window<float>(win, rel, out, W, T, C, layout, s);
  if (dtype == csn::kBF16)
    return launch_window<__nv_bfloat16>(win, rel, out, W, T, C, layout, s);
  return cudaErrorInvalidValue;
}

// rows [n_tiles * K, T] int32, win [W, C] f32 or bf16, out [n_tiles * T, C]
// f32; T a multiple of 8.
extern "C" int csn_probe_gather_accum(int dtype, int mode, const void* rows,
                                      const void* win, void* out, int n_tiles,
                                      int K, int W, int T, int C,
                                      void* stream) {
  if (n_tiles == 0 || T == 0 || C == 0) return cudaSuccess;
  if (W < 1 || K < 0 || T % ROWS != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csn::kF32)
    return launch_accum_mode<float>(mode, rows, win, out, n_tiles, K, W, T, C,
                                    s);
  if (dtype == csn::kBF16)
    return launch_accum_mode<__nv_bfloat16>(mode, rows, win, out, n_tiles, K,
                                            W, T, C, s);
  return cudaErrorInvalidValue;
}
