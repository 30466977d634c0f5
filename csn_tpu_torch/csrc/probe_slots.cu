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
// Every variant: a scratch of `n_slots` = 2 slots, slot 0 filled from x cast
// to the scratch's type (float -> int32 truncates toward zero), slot 1 zero,
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
// What bounds it on the H100: nothing but latency (out depends on 4 KB of x;
// reading those and writing out's 4 KB would take 0.0000024 ms, far below
// one launch, whose floor csn_empty_launch measures); the probe is about
// addressing, not speed. So
// the design shortens the chain of waits from the launch to the last store:
//   - every body reads only the slots' first 8 rows and 128 columns, so only
//     that part of each slot is written: slot 0's from x (4 KB), slot 1's
//     with zeros (the rest of the scratch is never read, and stays as it is);
//   - the fill is issued first: one 16-byte load of x a thread (four values,
//     cast on the way for the int32 slots); slot 1's 16 bytes are zeroed
//     while the load is in flight, and one barrier ends both;
//   - 256 threads, each owning 4 columns of one output row: the bodies load
//     16 bytes from the slot and out is written in 16-byte stores;
//   - the control: block 0 copies the 4 KB of x its body reads (rows 0-7,
//     contiguous) into its slot by the Tensor Memory Accelerator (one
//     cp.async.bulk into shared memory, completed on an mbarrier) while
//     block 1 zeroes the same rows of its own, one cluster barrier ends
//     both, and block 0 reads either block's slot in 16-byte loads;
//   - the launcher raises the control's shared-memory limit once per device.
// Filling the [8, 512] f32 slot by the TMA instead, eight bulk copies (one
// per strided 512-byte row) on an mbarrier, measured slower than the
// 16-byte loads; the control's 4 KB are one contiguous copy.

#include <atomic>
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int OUT_R = 8, OUT_C = 128;
constexpr int QUADS = OUT_C / 4;           // 16-byte pieces of an out row
constexpr int THREADS = OUT_R * QUADS;     // one thread per 4 outputs
constexpr int SLOT_R = 8, SLOT_W = 512;
constexpr int CTRL_R = 256, CTRL_C = 128;
constexpr size_t CTRL_BYTES = (size_t)CTRL_R * CTRL_C * sizeof(float);

template <typename S>
struct Vec4;
template <>
struct Vec4<float> {
  using T = float4;
};
template <>
struct Vec4<int32_t> {
  using T = int4;
};

template <typename V>
__device__ __forceinline__ float4 as_f32(V v) {
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}

__device__ __forceinline__ void add(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// x's values in the slot's type: f32 as they are, int32 cast toward zero,
// as numpy's astype(int32)
template <typename S>
__device__ __forceinline__ typename Vec4<S>::T cast_in(float4 v) {
  if constexpr (std::is_same_v<S, float>)
    return v;
  else
    return make_int4((int32_t)v.x, (int32_t)v.y, (int32_t)v.z, (int32_t)v.w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier that completes when `bytes` have landed: one arrival (the
// thread that issues the copies) and the copies' transaction bytes.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// cp.async.bulk: `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into this block's shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the first phase of `bar` to complete.
__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(0u)
      : "memory");
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
slot_load_kernel(int variant, const float* __restrict__ x,
                 float* __restrict__ out, int n_jobs, int n_slots) {
  using V = typename Vec4<S>::T;
  __shared__ __align__(128) S s[2][SLOT_R][SLOT_W];
  const int tid = threadIdx.x;
  const int r = tid / QUADS, c = 4 * (tid % QUADS);

  // slot 0's rows, columns [0, 128), from x: issued first
  const float4 xv = *reinterpret_cast<const float4*>(x + r * SLOT_W + c);
  // slot 1's: zeros, while the load is in flight
  *reinterpret_cast<V*>(&s[1][r][c]) = V{};
  *reinterpret_cast<V*>(&s[0][r][c]) = cast_in<S>(xv);
  __syncthreads();

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int j = 0; j < n_jobs; ++j) {
    const int slot = j % n_slots;
    if (variant == 1 || variant == 2) {
      add(acc, as_f32(*reinterpret_cast<const V*>(&s[slot][r][c])));
    } else if (variant == 4) {
      add(acc, as_f32(*reinterpret_cast<const V*>(&s[slot][3][c])));
    } else if (variant == 5) {
      V v = *reinterpret_cast<const V*>(&s[0][r][c]);
      for (int q = 1; q < n_slots; ++q)
        v = slot == q ? *reinterpret_cast<const V*>(&s[q][r][c]) : v;
      add(acc, as_f32(v));
    } else if (variant == 6) {
      const S* row = &s[slot][3][0];  // the [3:4] slice of the slot
      add(acc, as_f32(*reinterpret_cast<const V*>(row + c)));
    } else {  // 7: the thread's columns of the whole slot, then row 3
      V col[SLOT_R];
#pragma unroll
      for (int q = 0; q < SLOT_R; ++q)
        col[q] = *reinterpret_cast<const V*>(&s[slot][q][c]);
      add(acc, as_f32(col[3]));
    }
  }
  *reinterpret_cast<float4*>(out + r * OUT_C + c) = acc;
}

// the control: slot `rank` in the shared memory of block `rank` of the
// cluster; block 0 alone computes out
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS)
slot_load_control_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int n_jobs, int n_slots) {
  extern __shared__ __align__(128) float slot_mem[];  // [CTRL_R][CTRL_C]
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  if (rank == 0) {
    // slot 0's rows [0, 8), from x: one copy of 4 KB
    if (tid == 0) {
      bar_expect(&bar, OUT_R * CTRL_C * sizeof(float));
      bulk_copy(slot_mem, x, OUT_R * CTRL_C * sizeof(float), &bar);
    }
  } else {
    // slot 1's rows [0, 8): zeros
    reinterpret_cast<float4*>(slot_mem)[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cluster.sync();  // block 1's zeros (and block 0's mbarrier) visible
  if (rank == 0) {
    bar_wait(&bar);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int j = 0; j < n_jobs; ++j) {
      const float* s = cluster.map_shared_rank(slot_mem, j % n_slots);
      add(acc, reinterpret_cast<const float4*>(s)[tid]);
    }
    reinterpret_cast<float4*>(out)[tid] = acc;
  }
  cluster.sync();  // block 1's shared memory lives until block 0 has read it
}

// Nothing: the launch floor. Replaces no TPU kernel; its device time in a
// CUDA graph is the least time any launch takes on this card, the bound
// below which a kernel as small as slot_load_kernel cannot go.
__global__ void empty_kernel() {}

// The control's dynamic shared memory above 48 KB, raised once per device.
cudaError_t allow_control_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(slot_load_control_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)CTRL_BYTES);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace

// One launch of an empty kernel (one block of 32 threads) on `stream`.
extern "C" int csn_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// x: f32 [8, 512] (variant 3: [256, 128]), 16-byte aligned; out: f32
// [8, 128], 16-byte aligned.
extern "C" int csn_probe_slot_load(int variant, const void* x, void* out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const int n_jobs = 3, n_slots = 2;
  if (variant == 3) {
    cudaError_t err = allow_control_smem();
    if (err != cudaSuccess) return err;
    slot_load_control_kernel<<<2, THREADS, CTRL_BYTES, st>>>(xf, of, n_jobs,
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
