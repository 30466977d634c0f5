// Slot-load probe: value loads from a shared-memory scratch at a slot index
// known only at run time.
//
// Replaces: the Pallas probe kernels of scripts/probe_iw_bwd.py (probe with
// the bodies P1-P5 of main and P6-P7 of extra). On the TPU they pinpointed
// which load of a [slots, 8, window] scratch at a dynamic slot the compiler
// refused, for the interpolation backward's double-buffered tables. On this
// card shared memory is addressed at run time like any memory, and the kernel
// shows that every variant's load computes what its plain version computes.
//
// Every variant: a scratch of `n_slots` = 2 slots is zeroed, slot 0 is filled
// from x cast to the scratch's type (float -> int32 truncates toward zero),
// and out[8, 128] f32 = sum_{j < n_jobs} body(scratch[j % n_slots]) with
// n_jobs = 3. n_jobs and n_slots are kernel arguments, so the slot index is a
// run-time value for the compiler too.
//   1: int32 [2, 8, 512], body = slot[:, :128] as f32
//   2: f32   [2, 8, 512], body = slot[:, :128]
//   3: f32   [2, 256, 128] (the control, the conv kernels' scratch shape),
//      body = slot[:8, :128]
//   4: int32 [2, 8, 512], body = row slot[3, :128] broadcast over 8 rows
//   5: int32 [2, 8, 512], body = a select over the slots, [:, :128]
//   6: int32 [2, 8, 512], body = the slice slot[3:4, :128] broadcast
//   7: int32 [2, 8, 512], body = the whole slot loaded, then row 3 broadcast
//
// The control's scratch is 2 x 256 x 128 x 4 B = 256 KiB, more than the
// 227 KB one block can have. Its two slots therefore live in the two blocks
// of a thread block cluster, one slot each, and the run-time slot index picks
// the block whose shared memory is read (distributed shared memory).
//
// What bounds it on the H100: nothing but launch latency (x is at most 128 KB
// and out 4 KB); the probe is about addressing, not speed.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int OUT_R = 8, OUT_C = 128;
constexpr int THREADS = OUT_R * OUT_C;  // one thread per output element
constexpr int SLOT_R = 8, SLOT_W = 512;
constexpr int CTRL_R = 256, CTRL_C = 128;

template <typename S>
__device__ __forceinline__ S cast_in(float v);
template <>
__device__ __forceinline__ float cast_in<float>(float v) { return v; }
template <>
__device__ __forceinline__ int32_t cast_in<int32_t>(float v) {
  return (int32_t)v;  // truncates toward zero, as numpy's astype(int32)
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
slot_load_kernel(int variant, const float* __restrict__ x,
                 float* __restrict__ out, int n_jobs, int n_slots) {
  __shared__ S s[2][SLOT_R][SLOT_W];
  const int tid = threadIdx.x;
  const int r = tid / OUT_C, c = tid % OUT_C;
  S* flat = &s[0][0][0];
  for (int e = tid; e < 2 * SLOT_R * SLOT_W; e += THREADS) flat[e] = S(0);
  __syncthreads();
  for (int e = tid; e < SLOT_R * SLOT_W; e += THREADS)
    flat[e] = cast_in<S>(x[e]);
  __syncthreads();

  float acc = 0.f;
#pragma unroll 1
  for (int j = 0; j < n_jobs; ++j) {
    const int slot = j % n_slots;
    if (variant == 1 || variant == 2) {
      acc += (float)s[slot][r][c];
    } else if (variant == 4) {
      acc += (float)s[slot][3][c];
    } else if (variant == 5) {
      S v = s[0][r][c];
      for (int q = 1; q < n_slots; ++q) v = slot == q ? s[q][r][c] : v;
      acc += (float)v;
    } else if (variant == 6) {
      const S* row = &s[slot][3][0];  // the [3:4] slice of the slot
      acc += (float)row[c];
    } else {  // 7: the thread's column of the whole slot, then row 3
      S col[SLOT_R];
#pragma unroll
      for (int q = 0; q < SLOT_R; ++q) col[q] = s[slot][q][c];
      acc += (float)col[3];
    }
  }
  out[r * OUT_C + c] = acc;
}

// the control: slot `rank` in the shared memory of block `rank` of the cluster
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS)
slot_load_control_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int n_jobs, int n_slots) {
  extern __shared__ __align__(16) float slot_mem[];  // [CTRL_R][CTRL_C]
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  for (int e = tid; e < CTRL_R * CTRL_C; e += THREADS) slot_mem[e] = 0.f;
  __syncthreads();
  if (rank == 0)
    for (int e = tid; e < CTRL_R * CTRL_C; e += THREADS) slot_mem[e] = x[e];
  cluster.sync();  // both slots written before any block reads the other's

  if (rank == 0) {
    const int r = tid / OUT_C, c = tid % OUT_C;
    float acc = 0.f;
#pragma unroll 1
    for (int j = 0; j < n_jobs; ++j) {
      const float* s = cluster.map_shared_rank(slot_mem, j % n_slots);
      acc += s[r * CTRL_C + c];
    }
    out[r * OUT_C + c] = acc;
  }
  cluster.sync();  // block 1's shared memory lives until block 0 has read it
}

}  // namespace

// x: f32 [8, 512] (variant 3: [256, 128]); out: f32 [8, 128].
extern "C" int csn_probe_slot_load(int variant, const void* x, void* out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const int n_jobs = 3, n_slots = 2;
  if (variant == 3) {
    const size_t bytes = (size_t)CTRL_R * CTRL_C * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        slot_load_control_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    slot_load_control_kernel<<<2, THREADS, bytes, st>>>(xf, of, n_jobs,
                                                        n_slots);
    return cudaGetLastError();
  }
  if (variant == 2) {
    slot_load_kernel<float><<<1, THREADS, 0, st>>>(variant, xf, of, n_jobs,
                                                   n_slots);
    return cudaGetLastError();
  }
  if (variant == 1 || (variant >= 4 && variant <= 7)) {
    slot_load_kernel<int32_t><<<1, THREADS, 0, st>>>(variant, xf, of, n_jobs,
                                                     n_slots);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
