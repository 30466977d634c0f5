// Trilinear voxel -> point interpolation forward.
//
// Replaces: csn_tpu/core/interp_window.py _fwd_impl (Pallas body
// _interp_fwd_kernel), which the JAX package reaches through
// core/interp.py interp_batch.
//
// Computes out[p, c] = sum_{j<8} w[p, j] * flat[idx[p, j], c] in f32, where a
// corner index outside [0, n_vox) (the sentinel n_vox) adds nothing; the
// result is stored in the type of `flat`. Each output element is one fmaf
// chain from 0 over j = 0..7, sentinels skipped.
//
// What bounds it on the H100: it does 16 flops per output element against
// 8 gathered reads, so it is bound by memory traffic. The main path's voxel
// table (45056 x 39 f32 = 7 MB) stays in L2, so device memory sees the
// point side: 80000 x 8 x (4 + 4) B of corner tables and the output; but
// each voxel row is gathered once per live corner that names it (about
// 290000 of the 640000 corner slots name a voxel), in 32-byte sectors, so
// L2 serves about 6.5 reads of every row: 56 MB at 39 f32 channels.
//
// Design, two bodies of one kernel; the wrapper picks by the row
// (core/interp_window.py `row_vector`), and both give the same bits:
// - Wide rows of 16-byte pieces (32 to 64 pieces, one or two per lane: C
//   a multiple of 4 f32 or 8 bf16 channels from 128 to 256 f32 or 256 to
//   512 bf16, aligned; the extraction chain's 256). A warp takes 4 points: its 32 lanes load the 4 points' 8
//   (index, weight) pairs once, one coalesced 128-byte load each, and hand
//   them on by shuffles; then all 32 lanes walk one point's row at a time
//   in 16-byte pieces, the 8 corner loads of a piece in flight before its
//   FMAs.
// - Scalar rows (the heads' 39 classes): one thread per (point, channel
//   pair ch, ch + ceil(C / 2)), neighbouring threads on neighbouring
//   channels, so a warp reads a few points' corner rows as contiguous
//   segments and their (index, weight) rows as broadcast 16-byte loads
//   served by L1 (idx and w must start on a 16-byte boundary, which the
//   wrapper checks); all 16 corner loads of a thread are in flight before
//   its FMAs. On the H100 this beat one channel a thread at 39 f32
//   channels, and the warp-per-4-points body with scalar pieces lost to
//   both.
// Index arithmetic is 32-bit in both. The TPU kernel's voxel windows and
// one-hot matmuls exist because row gathers were slow there; a GPU gathers
// rows directly.

#include "interp_rows.cuh"

namespace {

using namespace csn_interp;

constexpr int WARPS = 8;   // warps per block
constexpr int GROUP = 4;   // points per warp: 4 x 8 corners, one per lane
constexpr int THREADS = 256;

// Scalar rows: one thread per (point, channel pair ch, ch + span), span =
// ceil(C / 2).
template <typename T>
__global__ void __launch_bounds__(THREADS)
interp_fwd_flat(const T* __restrict__ flat, const int32_t* __restrict__ idx,
                const float* __restrict__ w, T* __restrict__ out, int n_vox,
                int n_pts, int c) {
  const int span = (c + 1) / 2;
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_pts * span) return;
  const int p = t / span;
  const int ch = t - p * span;
  const bool two = ch + span < c;
  // the point's 8 indices and 8 weights: two 16-byte loads each
  const int4 i0 = reinterpret_cast<const int4*>(idx)[p * 2];
  const int4 i1 = reinterpret_cast<const int4*>(idx)[p * 2 + 1];
  const float4 w0 = reinterpret_cast<const float4*>(w)[p * 2];
  const float4 w1 = reinterpret_cast<const float4*>(w)[p * 2 + 1];
  const int v[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
  const float wj[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  float x[8], y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (v[j] >= 0 && v[j] < n_vox) {
      const T* row = flat + v[j] * c;
      x[j] = csn::to_f32(row[ch]);
      y[j] = two ? csn::to_f32(row[ch + span]) : 0.f;
    }
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (v[j] >= 0 && v[j] < n_vox) {
      a0 = fmaf(wj[j], x[j], a0);
      a1 = fmaf(wj[j], y[j], a1);
    }
  csn::store(a0, out + p * c + ch);
  if (two) csn::store(a1, out + p * c + ch + span);
}

// Wide rows of 16-byte pieces: a warp per 4 points, one point at a time.
template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
interp_fwd_rows(const T* __restrict__ flat, const int32_t* __restrict__ idx,
                const float* __restrict__ w, T* __restrict__ out, int n_vox,
                int n_pts, int c) {
  const int lane = threadIdx.x & 31;
  const int p0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * GROUP;
  if (p0 >= n_pts) return;  // the whole warp
  // lane l holds corner l % 8 of point p0 + l / 8
  const int e = p0 * 8 + lane;
  const bool have = p0 + lane / 8 < n_pts;
  const int my_v = have ? idx[e] : -1;
  const float my_w = have ? w[e] : 0.f;
  const int n_pieces = c / VEC;
#pragma unroll
  for (int q = 0; q < GROUP; ++q) {
    int v[8];
    float wq[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __shfl_sync(kFull, my_v, q * 8 + j);
      wq[j] = __shfl_sync(kFull, my_w, q * 8 + j);
    }
    if (p0 + q < n_pts) {
      T* row = out + (p0 + q) * c;
      for (int u = lane; u < n_pieces; u += 32) {
        Piece<T, VEC> x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (v[j] >= 0 && v[j] < n_vox)
            x[j] = load_piece<T, VEC>(flat + v[j] * c + u * VEC);
        float acc[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (v[j] >= 0 && v[j] < n_vox) {
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              acc[k] = fmaf(wq[j], piece_at(x[j], k), acc[k]);
          }
        store_piece(acc, row + u * VEC);
      }
    }
  }
}

template <typename T>
cudaError_t launch_flat(const void* flat, const void* idx, const void* w,
                        void* out, int n_vox, int n_pts, int c,
                        cudaStream_t stream) {
  const int n = n_pts * ((c + 1) / 2);
  interp_fwd_flat<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const T*>(flat), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), n_vox, n_pts, c);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_rows(const void* flat, const void* idx, const void* w,
                        void* out, int n_vox, int n_pts, int c,
                        cudaStream_t stream) {
  const int per_block = WARPS * GROUP;
  interp_fwd_rows<T, VEC>
      <<<(n_pts + per_block - 1) / per_block, WARPS * 32, 0, stream>>>(
          static_cast<const T*>(flat), static_cast<const int32_t*>(idx),
          static_cast<const float*>(w), static_cast<T*>(out), n_vox, n_pts,
          c);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// flat [n_vox, c] (f32 or bf16), idx and w [n_pts, 8] (int32, f32), out
// [n_pts, c] of flat's type, idx and w 16-byte aligned. vec: 1 (the scalar
// body), or 16 bytes of channels (4 f32, 8 bf16) when c is 32 to 64
// multiples of it and flat and out are 16-byte aligned (the wide body). Every index fits
// in 32 bits (n_vox * c, n_pts * c and n_pts * 8 below 2^31), which the
// wrapper checks.
extern "C" int csn_interp_fwd(int dtype, const void* flat, const void* idx,
                              const void* w, void* out, int n_vox, int n_pts,
                              int c, int vec, void* stream) {
  if (n_pts == 0 || c == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!aligned16(idx) || !aligned16(w) ||
      (vec != 1 && (c % vec || !aligned16(flat) || !aligned16(out))))
    return cudaErrorMisalignedAddress;
  if (dtype == csn::kF32) {
    if (vec == 1)
      return launch_flat<float>(flat, idx, w, out, n_vox, n_pts, c, s);
    if (vec == 4)
      return launch_rows<float, 4>(flat, idx, w, out, n_vox, n_pts, c, s);
  }
  if (dtype == csn::kBF16) {
    if (vec == 1)
      return launch_flat<__nv_bfloat16>(flat, idx, w, out, n_vox, n_pts, c, s);
    if (vec == 8)
      return launch_rows<__nv_bfloat16, 8>(flat, idx, w, out, n_vox, n_pts, c,
                                           s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* csn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
