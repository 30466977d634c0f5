// The interpolation pair's warp designs for rows of scalars, kept to be
// timed against the shipped scalar bodies (csrc/interp.cu, interp_bwd.cu)
// by tools/interp_designs.py. Not part of the kernel library.
//
// - fwd_warp<LPP>: a warp per 4 points. Its 32 lanes load the 4 points' 8
//   (index, weight) pairs once, one coalesced 128-byte load each, and
//   shuffles hand them to LPP lanes per point (32 / LPP points at once),
//   which stride the point's channels LPP apart.
// - bwd_group<LPV, NACC, VW>: LPV lanes per voxel (32: a warp per voxel, so
//   a warp's lanes never wait on another voxel's entry count). The group
//   loads up to LPV entries of its voxel at once, one coalesced load of
//   `ent` and of the weights, and shuffles hand each entry's point and
//   weight to every lane of the group; a lane keeps the sums of channels
//   sub, sub + LPV, ... (at most NACC) in registers. With VW the weights
//   come from a voxel-major copy (vw[e] = w[ent[e]], made once per batch),
//   so the w[pj] indirection leaves the loop.
// Every output element is the shipped kernels' fmaf chain in the same
// order (corners 0-7, sentinels skipped; CSR entries in order), so the
// outputs are bitwise equal to theirs.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int THREADS = 256;

template <typename T, int LPP>
__global__ void __launch_bounds__(THREADS)
fwd_warp(const T* __restrict__ flat, const int32_t* __restrict__ idx,
         const float* __restrict__ w, T* __restrict__ out, int n_vox,
         int n_pts, int c) {
  constexpr int AT_ONCE = 32 / LPP;
  const int lane = threadIdx.x & 31;
  const int p0 = (blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * 4;
  if (p0 >= n_pts) return;  // the whole warp
  const bool have = p0 + lane / 8 < n_pts;
  const int my_v = have ? idx[p0 * 8 + lane] : -1;
  const float my_w = have ? w[p0 * 8 + lane] : 0.f;
  const int sub = lane % LPP;
#pragma unroll
  for (int r = 0; r < 4 / AT_ONCE; ++r) {
    const int q = r * AT_ONCE + lane / LPP;
    int v[8];
    float wq[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __shfl_sync(kFull, my_v, q * 8 + j);
      wq[j] = __shfl_sync(kFull, my_w, q * 8 + j);
    }
    if (p0 + q < n_pts) {
      for (int u = sub; u < c; u += LPP) {
        float x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (v[j] >= 0 && v[j] < n_vox) x[j] = csn::to_f32(flat[v[j] * c + u]);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (v[j] >= 0 && v[j] < n_vox) acc = fmaf(wq[j], x[j], acc);
        csn::store(acc, out + (p0 + q) * c + u);
      }
    }
  }
}

template <typename T, int LPV, int NACC, bool VW>
__global__ void __launch_bounds__(THREADS)
bwd_group(const T* __restrict__ g, const int32_t* __restrict__ ptr,
          const int32_t* __restrict__ ent, const float* __restrict__ w,
          T* __restrict__ dflat, int n_vox, int c) {
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPV;
  const unsigned mask =
      LPV == 32 ? kFull : ((1u << LPV) - 1) << (lane - sub);
  const int v = (blockIdx.x * THREADS + threadIdx.x) / LPV;
  if (v >= n_vox) return;  // the whole group
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  const int e1 = ptr[v + 1];
  for (int eb = ptr[v]; eb < e1; eb += LPV) {
    const int n = min(LPV, e1 - eb);
    int my_p = 0;
    float my_w = 0.f;
    if (sub < n) {
      const int pj = ent[eb + sub];
      my_p = pj >> 3;
      my_w = VW ? w[eb + sub] : w[pj];
    }
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int p = __shfl_sync(mask, my_p, i, LPV);
      const float wi = __shfl_sync(mask, my_w, i, LPV);
      const T* row = g + p * c;
#pragma unroll
      for (int k = 0; k < NACC; ++k) {
        const int ch = sub + k * LPV;
        if (ch < c) acc[k] = fmaf(wi, csn::to_f32(row[ch]), acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    const int ch = sub + k * LPV;
    if (ch < c) csn::store(acc[k], dflat + v * c + ch);
  }
}

template <typename T, int LPP>
cudaError_t launch_fwd(const void* flat, const void* idx, const void* w,
                       void* out, int n_vox, int n_pts, int c,
                       cudaStream_t s) {
  const int per_block = THREADS / 32 * 4;
  fwd_warp<T, LPP><<<(n_pts + per_block - 1) / per_block, THREADS, 0, s>>>(
      static_cast<const T*>(flat), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), n_vox, n_pts, c);
  return cudaGetLastError();
}

template <typename T, int LPV, int NACC, bool VW>
cudaError_t launch_bwd_acc(const void* g, const void* ptr, const void* ent,
                           const void* w, void* dflat, int n_vox, int c,
                           cudaStream_t s) {
  const long n = static_cast<long>(n_vox) * LPV;
  bwd_group<T, LPV, NACC, VW>
      <<<static_cast<int>((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
          static_cast<const T*>(g), static_cast<const int32_t*>(ptr),
          static_cast<const int32_t*>(ent), static_cast<const float*>(w),
          static_cast<T*>(dflat), n_vox, c);
  return cudaGetLastError();
}

// The fewest accumulators (2, 4 or 8) that hold a lane's channels.
template <typename T, int LPV, bool VW>
cudaError_t launch_bwd(const void* g, const void* ptr, const void* ent,
                       const void* w, void* dflat, int n_vox, int c,
                       cudaStream_t s) {
  const int need = (c + LPV - 1) / LPV;
  if (need <= 2)
    return launch_bwd_acc<T, LPV, 2, VW>(g, ptr, ent, w, dflat, n_vox, c, s);
  if (need <= 4)
    return launch_bwd_acc<T, LPV, 4, VW>(g, ptr, ent, w, dflat, n_vox, c, s);
  if (need <= 8)
    return launch_bwd_acc<T, LPV, 8, VW>(g, ptr, ent, w, dflat, n_vox, c, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run(int design, const void* a, const void* b, const void* e,
                const void* w, void* out, int n_vox, int n_pts, int c,
                cudaStream_t s) {
  switch (design) {
    case 0: return launch_fwd<T, 8>(a, b, w, out, n_vox, n_pts, c, s);
    case 1: return launch_fwd<T, 16>(a, b, w, out, n_vox, n_pts, c, s);
    case 2: return launch_fwd<T, 32>(a, b, w, out, n_vox, n_pts, c, s);
    case 10: return launch_bwd<T, 8, false>(a, b, e, w, out, n_vox, c, s);
    case 11: return launch_bwd<T, 16, false>(a, b, e, w, out, n_vox, c, s);
    case 12: return launch_bwd<T, 32, false>(a, b, e, w, out, n_vox, c, s);
    case 13: return launch_bwd<T, 8, true>(a, b, e, w, out, n_vox, c, s);
    case 14: return launch_bwd<T, 16, true>(a, b, e, w, out, n_vox, c, s);
    case 15: return launch_bwd<T, 32, true>(a, b, e, w, out, n_vox, c, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// design 0-2: the forward at LPP 8, 16, 32 (a: flat, b: idx, w: weights
// [n_pts, 8]); 10-12: the backward at LPV 8, 16, 32 (a: g, b: ptr, e: ent,
// w: weights [n_pts, 8]); 13-15: the same over voxel-major weights (w:
// [ptr[n_vox]]). Returns the CUDA error code of the launch.
extern "C" int csn_interp_design(int design, int dtype, const void* a,
                                 const void* b, const void* e, const void* w,
                                 void* out, int n_vox, int n_pts, int c,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csn::kF32)
    return run<float>(design, a, b, e, w, out, n_vox, n_pts, c, s);
  if (dtype == csn::kBF16)
    return run<__nv_bfloat16>(design, a, b, e, w, out, n_vox, n_pts, c, s);
  return cudaErrorInvalidValue;
}
