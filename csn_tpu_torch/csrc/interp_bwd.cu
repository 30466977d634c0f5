// Trilinear voxel -> point interpolation backward: the gradient of the voxel
// table.
//
// Replaces: csn_tpu/core/interp_window.py _bwd_impl (Pallas body
// _interp_bwd_kernel), which the JAX package reaches through the custom VJP
// of interp_window_apply from core/interp.py interp_batch.
//
// Computes dflat[v, c] = sum over the (point p, corner j) with idx[p, j] == v
// of w[p, j] * g[p, c], in f32, stored in the type of g. The (p, j) of voxel
// v come from a voxel-major transpose table in CSR form: entries
// ent[ptr[v] .. ptr[v+1]) hold p * 8 + j, built on the host by a stable
// argsort of the corner table (csn_tpu_torch/core/pyramid.py), the port's
// counterpart of the JAX host's `win!interp_b` worklist.
//
// What bounds it on the H100: memory traffic, 2 flops per gathered g value.
// The main path's g (80000 x 39 f32 = 12.5 MB) stays in the 50 MB L2, so the
// cost is the table and the voxel rows: 640000 entries and 45056 x 39
// outputs.
//
// Design: one thread per (voxel, channel), neighbouring threads on
// neighbouring channels of one voxel, so each entry's (index, weight) read
// is a broadcast and its g read a contiguous row segment. Every output is
// written by exactly one thread in a fixed order: deterministic, no scatter,
// no atomics, as in the TPU kernel.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
interp_bwd_kernel(const T* __restrict__ g, const int32_t* __restrict__ ptr,
                  const int32_t* __restrict__ ent,
                  const float* __restrict__ w, T* __restrict__ dflat,
                  int64_t n_vox, int c) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_vox * c) return;
  const int64_t v = t / c;
  const int ch = (int)(t - v * c);
  float acc = 0.f;
  const int32_t e1 = ptr[v + 1];
  for (int32_t e = ptr[v]; e < e1; ++e) {
    const int64_t pj = ent[e];
    acc = fmaf(w[pj], csn::to_f32(g[(pj >> 3) * c + ch]), acc);
  }
  csn::store(acc, dflat + t);
}

template <typename T>
cudaError_t launch(const void* g, const void* ptr, const void* ent,
                   const void* w, void* dflat, int64_t n_vox, int c,
                   cudaStream_t stream) {
  const int64_t n = n_vox * c;
  interp_bwd_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                         stream>>>(
      static_cast<const T*>(g), static_cast<const int32_t*>(ptr),
      static_cast<const int32_t*>(ent), static_cast<const float*>(w),
      static_cast<T*>(dflat), n_vox, c);
  return cudaGetLastError();
}

}  // namespace

// g [n_pts, c] (f32 or bf16), ptr [n_vox + 1] and ent [ptr[n_vox]] int32,
// w [n_pts, 8] f32, dflat [n_vox, c] of g's type.
extern "C" int csn_interp_bwd(int dtype, const void* g, const void* ptr,
                              const void* ent, const void* w, void* dflat,
                              int64_t n_vox, int c, void* stream) {
  if (n_vox == 0 || c == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csn::kF32)
    return launch<float>(g, ptr, ent, w, dflat, n_vox, c, s);
  if (dtype == csn::kBF16)
    return launch<__nv_bfloat16>(g, ptr, ent, w, dflat, n_vox, c, s);
  return cudaErrorInvalidValue;
}
