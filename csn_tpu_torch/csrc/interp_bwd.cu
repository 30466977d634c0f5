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
// counterpart of the JAX host's `win!interp_b` worklist. Each output element
// is one fmaf chain from 0 over its voxel's entries in CSR order.
//
// What bounds it on the H100: memory traffic, 2 flops per gathered g value.
// The main path's g (80000 x 39 f32 = 12.5 MB) stays in the 50 MB L2, so
// device memory sees the table and the voxel rows: about 290000 entries
// (the live ones of 640000 corner slots) and 45056 x 39 outputs; but each g
// row is gathered once per live corner, so L2 serves about 6.5 rows per
// voxel.
//
// Design, two bodies of one kernel; the wrapper picks by the row
// (core/interp_window.py `row_vector`), and both give the same bits:
// - Scalar rows (the heads' 39 classes): one thread per (voxel, channel
//   pair ch, ch + ceil(C / 2)), neighbouring threads on neighbouring
//   channels, each walking its voxel's entries in order with two sums in
//   registers; the entry and weight loads of a voxel's threads are
//   broadcasts served by L1, and a warp reads each entry's g row as one or
//   two contiguous segments. On the H100 this beat a warp per voxel (whose
//   lanes share the entry count but leave 25 of 64 channel slots idle at
//   39 channels, at half the warps per SM) and one channel per thread.
// - Wide rows of 16-byte pieces (32 to 64 pieces, one or two per lane: C
//   a multiple of 4 f32 or 8 bf16 channels from 128 to 256 f32 or 256 to
//   512 bf16, aligned; the extraction chain's 256): a warp sums a run of
//   RUN consecutive
//   voxels, whose entries are one contiguous stretch of `ent`, all its
//   lanes on one voxel at a time, so they share every entry count. It
//   reads up to 32 entries at once, one coalesced load of `ent`, each lane
//   fetching its entry's weight, and shuffles hand every entry's point and
//   weight to all lanes. A lane owns SLOTS (1 or 2) 16-byte pieces of the row and
//   keeps their sums in registers, UNROLL entries' g loads in flight before
//   their FMAs, and stores a voxel's row when its entries end.
// Every output is written once by one thread in a fixed order:
// deterministic, no scatter, no atomics, as in the TPU kernel.

#include "interp_rows.cuh"

namespace {

using namespace csn_interp;

constexpr int WARPS = 8;  // warps per block of the 16-byte body
constexpr int RUN = 2;    // consecutive voxels per warp
constexpr int THREADS = 256;

// Scalar rows: one thread per (voxel, channel pair ch, ch + span), span =
// ceil(C / 2).
template <typename T>
__global__ void __launch_bounds__(THREADS)
interp_bwd_flat(const T* __restrict__ g, const int32_t* __restrict__ ptr,
                const int32_t* __restrict__ ent, const float* __restrict__ w,
                T* __restrict__ dflat, int n_vox, int c) {
  const int span = (c + 1) / 2;
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_vox * span) return;
  const int v = t / span;
  const int ch = t - v * span;
  const bool two = ch + span < c;
  float a0 = 0.f, a1 = 0.f;
  const int e1 = ptr[v + 1];
  for (int e = ptr[v]; e < e1; ++e) {
    const int pj = ent[e];
    const float wj = w[pj];
    const T* row = g + (pj >> 3) * c;
    a0 = fmaf(wj, csn::to_f32(row[ch]), a0);
    if (two) a1 = fmaf(wj, csn::to_f32(row[ch + span]), a1);
  }
  csn::store(a0, dflat + v * c + ch);
  if (two) csn::store(a1, dflat + v * c + ch + span);
}

// Wide rows of 16-byte pieces: a warp per run of RUN voxels.
template <typename T, int VEC, int SLOTS>
__global__ void __launch_bounds__(WARPS * 32)
interp_bwd_rows(const T* __restrict__ g, const int32_t* __restrict__ ptr,
                const int32_t* __restrict__ ent, const float* __restrict__ w,
                T* __restrict__ dflat, int n_vox, int c) {
  constexpr int UNROLL = 4;  // entries whose g loads are in flight at once
  const int lane = threadIdx.x & 31;
  const int v0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * RUN;
  if (v0 >= n_vox) return;  // the whole warp
  const int nv = min(RUN, n_vox - v0);
  // lane k <= nv holds ptr[v0 + k]: the run's entries are one contiguous
  // stretch of ent, cut at these bounds
  const int my_ptr = lane <= nv ? ptr[v0 + lane] : 0;
  const int e_begin = __shfl_sync(kFull, my_ptr, 0);
  const int e_end = __shfl_sync(kFull, my_ptr, nv);
  const int n_pieces = c / VEC;  // at most SLOTS x 32
  float acc[SLOTS][VEC];
  // the run's voxel being summed, and the entry where it ends
  int cur = 0;
  int next = __shfl_sync(kFull, my_ptr, 1);
  auto reset = [&] {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[s][k] = 0.f;
  };
  // store voxel cur's sums, then start the next voxel from 0
  auto finish = [&] {
    T* row = dflat + (v0 + cur) * c;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int u = lane + s * 32;
      if (u < n_pieces) store_piece(acc[s], row + u * VEC);
    }
    reset();
    ++cur;
    next = __shfl_sync(kFull, my_ptr, min(cur + 1, nv));
  };
  reset();
  for (int eb = e_begin; eb < e_end; eb += 32) {
    const int n = min(32, e_end - eb);
    int my_p = 0;
    float my_w = 0.f;
    if (lane < n) {
      const int pj = ent[eb + lane];
      my_p = pj >> 3;
      my_w = w[pj];
    }
    for (int i = 0; i < n; i += UNROLL) {
      int p[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        p[k] = __shfl_sync(kFull, my_p, i + k);
      Piece<T, VEC> x[UNROLL][SLOTS];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        if (i + k < n)
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            const int u = lane + s * 32;
            if (u < n_pieces)
              x[k][s] = load_piece<T, VEC>(g + p[k] * c + u * VEC);
          }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const float wk = __shfl_sync(kFull, my_w, i + k);
        if (i + k < n) {
          // entry eb + i + k starts the next voxel with entries (the
          // bound check is the same on every lane)
          while (eb + i + k == next) finish();
#pragma unroll
          for (int s = 0; s < SLOTS; ++s)
            if (lane + s * 32 < n_pieces)
#pragma unroll
              for (int kk = 0; kk < VEC; ++kk)
                acc[s][kk] = fmaf(wk, piece_at(x[k][s], kk), acc[s][kk]);
        }
      }
    }
  }
  while (cur < nv) finish();  // the last voxel with entries, empty ones
}

template <typename T>
cudaError_t launch_flat(const void* g, const void* ptr, const void* ent,
                        const void* w, void* dflat, int n_vox, int c,
                        cudaStream_t stream) {
  const int n = n_vox * ((c + 1) / 2);
  interp_bwd_flat<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int32_t*>(ptr),
      static_cast<const int32_t*>(ent), static_cast<const float*>(w),
      static_cast<T*>(dflat), n_vox, c);
  return cudaGetLastError();
}

template <typename T, int VEC, int SLOTS>
cudaError_t launch_rows(const void* g, const void* ptr, const void* ent,
                        const void* w, void* dflat, int n_vox, int c,
                        cudaStream_t stream) {
  const int per_block = WARPS * RUN;
  interp_bwd_rows<T, VEC, SLOTS>
      <<<(n_vox + per_block - 1) / per_block, WARPS * 32, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const int32_t*>(ptr),
          static_cast<const int32_t*>(ent), static_cast<const float*>(w),
          static_cast<T*>(dflat), n_vox, c);
  return cudaGetLastError();
}

// The wide body for rows of 32 to 64 pieces: one or two per lane.
template <typename T, int VEC>
cudaError_t launch_slots(const void* g, const void* ptr, const void* ent,
                         const void* w, void* dflat, int n_vox, int c,
                         cudaStream_t s) {
  const int n_pieces = c / VEC;
  if (n_pieces < 32 || n_pieces > 64) return cudaErrorInvalidValue;
  if (n_pieces == 32)
    return launch_rows<T, VEC, 1>(g, ptr, ent, w, dflat, n_vox, c, s);
  return launch_rows<T, VEC, 2>(g, ptr, ent, w, dflat, n_vox, c, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// g [n_pts, c] (f32 or bf16), ptr [n_vox + 1] and ent [ptr[n_vox]] int32,
// w [n_pts, 8] f32, dflat [n_vox, c] of g's type. vec: 1 (the scalar body),
// or 16 bytes of channels (4 f32, 8 bf16) when c is 32 to 64 multiples of
// it and g and dflat are 16-byte aligned (the wide body). Every index fits
// in 32 bits (n_vox * c, n_pts * c and n_pts * 8 below 2^31), which the
// wrapper checks.
extern "C" int csn_interp_bwd(int dtype, const void* g, const void* ptr,
                              const void* ent, const void* w, void* dflat,
                              int n_vox, int c, int vec, void* stream) {
  if (n_vox == 0 || c == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec != 1 && (c % vec || !aligned16(g) || !aligned16(dflat)))
    return cudaErrorMisalignedAddress;
  if (dtype == csn::kF32) {
    if (vec == 1)
      return launch_flat<float>(g, ptr, ent, w, dflat, n_vox, c, s);
    if (vec == 4)
      return launch_slots<float, 4>(g, ptr, ent, w, dflat, n_vox, c, s);
  }
  if (dtype == csn::kBF16) {
    if (vec == 1)
      return launch_flat<__nv_bfloat16>(g, ptr, ent, w, dflat, n_vox, c, s);
    if (vec == 8)
      return launch_slots<__nv_bfloat16, 8>(g, ptr, ent, w, dflat, n_vox, c,
                                            s);
  }
  return cudaErrorInvalidValue;
}
