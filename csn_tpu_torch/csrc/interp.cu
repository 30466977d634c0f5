// Trilinear voxel -> point interpolation forward.
//
// Replaces: csn_tpu/core/interp_window.py _fwd_impl (Pallas body
// _interp_fwd_kernel), which the JAX package reaches through
// core/interp.py interp_batch.
//
// Computes out[p, c] = sum_{j<8} w[p, j] * flat[idx[p, j], c] in f32, where a
// corner index outside [0, n_vox) (the sentinel n_vox) adds nothing; the
// result is stored in the type of `flat`.
//
// What bounds it on the H100: it does 16 flops per output element against
// 8 gathered reads, so it is bound by memory traffic. The voxel table of the
// main path (45056 x 39 f32 = 7 MB) stays in L2, so the cost is the point
// side: 80000 x 8 x (4 + 4) B of corner tables and the output.
//
// Design: one thread per (point, channel). Neighbouring threads handle
// neighbouring channels of one point, so the corner gathers of a point are
// contiguous row reads and the 8 (index, weight) pairs are broadcast loads.
// The TPU kernel's voxel windows and one-hot matmuls exist because row
// gathers were slow there; a GPU gathers rows directly.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
interp_fwd_kernel(const T* __restrict__ flat, const int32_t* __restrict__ idx,
                  const float* __restrict__ w, T* __restrict__ out,
                  int64_t n_vox, int64_t n_pts, int c) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_pts * c) return;
  const int64_t p = t / c;
  const int ch = (int)(t - p * c);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t v = idx[p * 8 + j];
    if (v >= 0 && v < n_vox)
      acc = fmaf(w[p * 8 + j], csn::to_f32(flat[v * c + ch]), acc);
  }
  csn::store(acc, out + t);
}

template <typename T>
cudaError_t launch(const void* flat, const void* idx, const void* w, void* out,
                   int64_t n_vox, int64_t n_pts, int c, cudaStream_t stream) {
  const int64_t n = n_pts * c;
  interp_fwd_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                         stream>>>(
      static_cast<const T*>(flat), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), n_vox, n_pts, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int csn_interp_fwd(int dtype, const void* flat, const void* idx,
                              const void* w, void* out, int64_t n_vox,
                              int64_t n_pts, int c, void* stream) {
  if (n_pts == 0 || c == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csn::kF32)
    return launch<float>(flat, idx, w, out, n_vox, n_pts, c, s);
  if (dtype == csn::kBF16)
    return launch<__nv_bfloat16>(flat, idx, w, out, n_vox, n_pts, c, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* csn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
