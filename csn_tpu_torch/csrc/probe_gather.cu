// Gather probes: rows taken from a window staged in shared memory, from
// device memory / L2, or by a one-hot product on the tensor cores.
//
// Replaces: the Pallas probe kernels of scripts/probe_dyngather.py (k_take,
// k_take_along, k_take_along_t and _timing_kernel) and of
// scripts/probe_dyngather2.py (k_matched_sublane, k_matched_lane and
// _timing_kernel). On the TPU they asked whether a kernel can gather rows
// from a window in fast memory or must multiply by a one-hot matrix; the
// answer shaped the conv kernels of csn_tpu/core/window_conv.py. On this card
// the same question decides where the conv kernels' gather stage should read
// from, and whether a one-hot product on the tensor cores can compete with a
// gather: each form here is the one a kernel for this card would use.
//
// csn_probe_window_gather: out[i, :] = win[rel[i], :] for i < T, win [W, C],
// rel int32 (a row id outside [0, W) gives a zero row). The channels are
// split into slabs of `slab` <= 32 channels, one block of 1024 threads each
// (C = 128: four blocks on four SMs); a block stages its slab of every
// window row in shared memory and gathers its T rows from there, each thread
// loading a few row ids before it uses them.
//   layout 0 keeps the slab as [W, slab]: 16-byte cp.async in, one 16-byte
//     vector per (row, piece) out; eight threads read one 128-byte slab row.
//   layout 1 stages the slab transposed, [slab, P], and gathers along the
//     fast axis (the probe scripts' take_along_axis on the lane dimension):
//     a warp per output row, a lane per channel, so neighbouring lanes read
//     addresses P words apart. P is odd (W + 1 words at W = 384 or 256), so
//     the 32 lanes hit 32 distinct banks.
// The matched form of probe_dyngather2.py is this kernel called with T = W
// and padded indices.
//
// csn_probe_gather_accum: for tile t < n_tiles and i < T,
//   out[t*T + i, :] = sum_{k < K} valid(r) * win[r, :], r = rows[t*K + k, i],
// rows int32 [n_tiles*K, T], out f32 [n_tiles*T, C], valid(r) = 0 <= r < W,
// the offsets summed in the order k = 0 .. K-1 in f32, no atomics.
// Persistent blocks: the wrapper sizes the grid to the blocks that fit on
// the card at once (probes/dyngather.py accum_launch), and the work items
// are dealt to the blocks in turn.
//   mode 0 "onehot": acc += onehot[rows, W] @ win, the TPU's production form,
//     on the tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums). The
//     window is staged once per block (rows padded with zeros to a multiple
//     of 16). A warp owns 16 MT output rows by COLS channels (bf16: 32 x 64;
//     f32: 64 x 32), builds the one-hot A fragments in registers straight
//     from the row ids (bf16 1.0 shifted into place by the id's distance to
//     the column, one shift per register; never stored), and keeps its f32
//     accumulators in registers across the K offsets. The product is dense:
//     every 16-row k-step of the window is multiplied, empty or not. A bf16
//     window is read with ldmatrix.trans at a row pitch of C + 8 elements (an
//     odd multiple of 16 bytes: conflict-free), every pair's fragments before
//     the products. An f32 window stays f32 in shared memory (pitch C + 4
//     words, conflict-free for the fragment loads) and is split in registers
//     into three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
//     hi - mid), which hold its 24 significant bits: a one-hot row selects
//     one element, so the three products give x exactly, and the f32 line
//     costs three products; each split fragment serves four m-tiles.
//   mode 1 "smem": one block of 1024 threads per SM stages the window once
//     with 16-byte cp.async; rows gathered from it as in mode 2.
//   mode 2 "global": rows gathered straight from device memory (the window,
//     at most 196 KB, stays in L1 / L2; this body uses no shared memory, and
//     runs three blocks of 256 threads per SM: more warps evict the window
//     from L1), as K1 does today.
//   Modes 1 and 2: a warp per group of 32 output rows. Lane l loads the row
//   ids of the group's row l, one coalesced load per offset; a lane then
//   owns 16 bytes of a row's source (8 bf16 or 4 f32 channels), takes its
//   row's ids from their owner lane by shuffles, loads KC rows at once, and
//   writes its f32 sums as 16-byte streaming stores.
//
// What bounds it on the H100: bytes. Every mode reads the row ids once and
// writes the f32 output once (46.1 MB + 3.2 MB at 352 tiles x 9 offsets x
// 256 rows x 128 channels). The one-hot product does 2*rows*W*C operations
// per offset on top (79.7 GFLOP there, 0.081 ms at the bf16 tensor peak;
// three times that with an f32 window), so it is bound by operations.

#include "flash_tc.cuh"

namespace {

using csn_tc::bf16;

constexpr int THREADS = 256;     // global-gather blocks
constexpr int WIN_THREADS = 1024;  // window-gather blocks
constexpr int GLOBAL_MIN_BLOCKS = 3;  // global-gather blocks per SM
constexpr int SMEM_THREADS = 1024;    // smem-gather block: one per SM
constexpr int KC = 3;            // rows a gather lane loads at once
constexpr int KMAX = 12;         // offsets whose row ids a lane holds
constexpr int GROUP = 32;        // output rows of a gather warp's group
constexpr int WB = 4;            // elements a window-gather thread batches
constexpr int SMEM_MAX = 232448; // dynamic shared memory of one block

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // channels of a 16-byte piece
};

// one-hot geometry per window type (probes/dyngather.py ONEHOT): warps of
// a block, blocks per SM, row padding of the staged window (elements),
// m-tiles (16 output rows) and channels of a warp's item
template <typename T>
struct OneHot;
template <>
struct OneHot<bf16> {
  static constexpr int WARPS = 8, MIN_BLOCKS = 2, PAD = 8, MT = 2, COLS = 64;
};
template <>
struct OneHot<float> {
  static constexpr int WARPS = 12, MIN_BLOCKS = 1, PAD = 4, MT = 4, COLS = 32;
};

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// probe_window_gather
// ---------------------------------------------------------------------------

// odd pitch, in elements, of a transposed slab row of W elements (W + 1
// words at an even word count)
template <typename T>
__host__ __device__ inline int lane_pitch(int W) {
  const int words = (int)((W * sizeof(T) + 3) / 4);
  return (words | 1) * 4 / (int)sizeof(T);
}

template <typename T>
inline size_t window_smem(int W, int slab, int layout) {
  return layout == 0 ? (size_t)W * slab * sizeof(T)
                     : (size_t)slab * lane_pitch<T>(W) * sizeof(T);
}

template <typename T, int LAYOUT>
__global__ void __launch_bounds__(WIN_THREADS, 1)
window_gather_kernel(const T* __restrict__ win, const int32_t* __restrict__ rel,
                     T* __restrict__ out, int W, int n_rows, int C,
                     int slab) {
  constexpr int VEC = Vec<T>::N;
  constexpr int NW = WIN_THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * slab;
  const int sc = min(slab, C - c0);   // channels of this block's slab
  const int pps = sc / VEC;           // 16-byte pieces of a slab row
  // each thread handles WB of its elements at once: their loads first,
  // so that one latency covers WB of them
  if (LAYOUT == 0) {
    for (int e = tid; e < W * pps; e += WIN_THREADS) {
      const int w = e / pps, q = e - w * pps;
      csn_tc::cp_async16(ws + (size_t)w * slab + q * VEC,
                         win + (size_t)w * C + c0 + q * VEC, true);
    }
    csn_tc::cp_async_commit();
    csn_tc::cp_async_wait<0>();
    __syncthreads();
    const uint4* ws4 = reinterpret_cast<const uint4*>(ws);
    const int n = n_rows * pps;
    for (int e0 = tid; e0 < n; e0 += WB * WIN_THREADS) {
      int32_t r[WB];
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int e = e0 + u * WIN_THREADS;
        r[u] = e < n ? __ldg(rel + e / pps) : -1;
      }
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int e = e0 + u * WIN_THREADS;
        if (e >= n) continue;
        const int i = e / pps, q = e - i * pps;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r[u] >= 0 && r[u] < W) v = ws4[((size_t)r[u] * slab) / VEC + q];
        *reinterpret_cast<uint4*>(out + (size_t)i * C + c0 + q * VEC) = v;
      }
    }
  } else {
    const int P = lane_pitch<T>(W);
    // staged transposed: ws[c * P + w] = win[w, c0 + c]; consecutive threads
    // take consecutive pieces of a row, then the next rows: the stores of
    // one instruction land on 32 distinct banks (P odd in words)
    const int n = W * pps;
    for (int e0 = tid; e0 < n; e0 += WB * WIN_THREADS) {
      uint4 v[WB];
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int e = e0 + u * WIN_THREADS;
        if (e < n) {
          const int w = e / pps, q = e - w * pps;
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              win + (size_t)w * C + c0 + q * VEC));
        }
      }
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int e = e0 + u * WIN_THREADS;
        if (e >= n) continue;
        const int w = e / pps, q = e - w * pps;
        const T* x = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) ws[(size_t)(q * VEC + j) * P + w] = x[j];
      }
    }
    __syncthreads();
    // a warp per output row, a lane per channel of the slab (slab <= 32)
    for (int i0 = warp; i0 < n_rows; i0 += WB * NW) {
      int32_t r[WB];
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int i = i0 + u * NW;
        r[u] = i < n_rows ? __ldg(rel + i) : -1;
      }
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int i = i0 + u * NW;
        if (i >= n_rows || lane >= sc) continue;
        T v = T(0.f);
        if (r[u] >= 0 && r[u] < W) v = ws[(size_t)lane * P + r[u]];
        out[(size_t)i * C + c0 + lane] = v;
      }
    }
  }
}

template <typename T, int LAYOUT>
cudaError_t launch_window(const void* win, const void* rel, void* out, int W,
                          int n_rows, int C, int slab, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      window_gather_kernel<T, LAYOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const size_t bytes = window_smem<T>(W, slab, LAYOUT);
  if (bytes > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  window_gather_kernel<T, LAYOUT>
      <<<(unsigned)((C + slab - 1) / slab), WIN_THREADS, bytes, stream>>>(
          static_cast<const T*>(win), static_cast<const int32_t*>(rel),
          static_cast<T*>(out), W, n_rows, C, slab);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// probe_gather_accum, modes 1 and 2: the gathers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void add16(float (&acc)[4], const uint4& v) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}
__device__ __forceinline__ void add16(float (&acc)[8], const uint4& v) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[j]));
    acc[2 * j] += f.x;
    acc[2 * j + 1] += f.y;
  }
}

template <bool SMEM>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  if (SMEM) return *p;
  return __ldg(p);
}

// A warp per group of GROUP consecutive output rows, the groups walked by
// the whole grid. Lane l loads the row ids of the group's row l, KMAX
// offsets at a time, with one coalesced load per offset; then the warp
// walks the group's (row, 16-byte piece) slots 32 at a time, each lane
// taking its slot's row ids from their owner lane by a shuffle and loading
// KC rows at once. src is the window as 16-byte pieces, in shared or device
// memory. Past KMAX offsets the sums continue from the f32 output (the same
// roundings, in the same order).
template <typename T, bool SMEM, int NT>
__device__ __forceinline__ void gather_rows(const int32_t* __restrict__ rows,
                                            const uint4* src,
                                            float* __restrict__ out, int K,
                                            int W, int T_rows, int C,
                                            int64_t n_rows) {
  constexpr int VEC = Vec<T>::N;
  const int ppr = C / VEC;
  const int lane = threadIdx.x & 31;
  const int64_t n_groups = (n_rows + GROUP - 1) / GROUP;
  // the groups dealt to the blocks in turn, so that every block has work
  const int64_t step = (int64_t)gridDim.x * (NT / 32);
  for (int64_t grp = (int64_t)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
       grp < n_groups; grp += step) {
    const int64_t row0 = grp * GROUP;
    const int n_live = (int)min((int64_t)GROUP, n_rows - row0);
    const bool live = lane < n_live;
    const int64_t tile = live ? (row0 + lane) / T_rows : 0;
    const int32_t* ids =
        rows + tile * K * T_rows + (live ? row0 + lane - tile * T_rows : 0);
    const int n_slots = n_live * ppr;
    for (int k0 = 0; k0 < K; k0 += KMAX) {
      const int kn = min(KMAX, K - k0);
      int32_t r[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        int32_t v = -1;
        if (live && j < kn) v = __ldg(ids + (int64_t)(k0 + j) * T_rows);
        r[j] = v >= 0 && v < W ? v : -1;
      }
      for (int s0 = 0; s0 < n_slots; s0 += 32) {
        const int s = s0 + lane;
        const bool on = s < n_slots;
        const int j = on ? s / ppr : 0;
        const int p = s - j * ppr;
        float* o = out + (row0 + j) * C + (int64_t)p * VEC;
        float acc[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
        if (k0 > 0 && on) {
#pragma unroll
          for (int q = 0; q < VEC / 4; ++q) {
            const float4 f = reinterpret_cast<const float4*>(o)[q];
            acc[4 * q] = f.x;
            acc[4 * q + 1] = f.y;
            acc[4 * q + 2] = f.z;
            acc[4 * q + 3] = f.w;
          }
        }
#pragma unroll
        for (int c = 0; c < KMAX; c += KC) {
          if (c < kn) {
            int32_t id[KC];
            uint4 v[KC];
#pragma unroll
            for (int q = 0; q < KC; ++q) {
              id[q] = __shfl_sync(0xffffffffu, r[c + q], j);
              v[q] = on && id[q] >= 0 ? load16<SMEM>(src + (id[q] * ppr + p))
                                      : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int q = 0; q < KC; ++q)   // in the order of the offsets
              if (id[q] >= 0) add16(acc, v[q]);
          }
        }
        if (on) {
#pragma unroll
          for (int q = 0; q < VEC / 4; ++q)
            __stcs(reinterpret_cast<float4*>(o) + q,
                   make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                               acc[4 * q + 3]));
        }
      }
    }
  }
}

// mode 2: blocks of THREADS, GLOBAL_MIN_BLOCKS per SM (more warps evict the
// window from L1)
template <typename T>
__global__ void __launch_bounds__(THREADS, GLOBAL_MIN_BLOCKS)
gather_global_kernel(const int32_t* __restrict__ rows,
                     const T* __restrict__ win, float* __restrict__ out,
                     int K, int W, int T_rows, int C, int64_t n_rows) {
  gather_rows<T, false, THREADS>(rows, reinterpret_cast<const uint4*>(win),
                                 out, K, W, T_rows, C, n_rows);
}

// mode 1: one block of SMEM_THREADS per SM stages the window once
template <typename T>
__global__ void __launch_bounds__(SMEM_THREADS, 1)
gather_smem_kernel(const int32_t* __restrict__ rows,
                   const T* __restrict__ win, float* __restrict__ out, int K,
                   int W, int T_rows, int C, int64_t n_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ws = reinterpret_cast<uint4*>(smem_raw);
  const uint4* src = reinterpret_cast<const uint4*>(win);
  const int n = W * (C / Vec<T>::N);
  for (int e = threadIdx.x; e < n; e += SMEM_THREADS)
    csn_tc::cp_async16(ws + e, src + e, true);
  csn_tc::cp_async_commit();
  csn_tc::cp_async_wait<0>();
  __syncthreads();
  gather_rows<T, true, SMEM_THREADS>(rows, ws, out, K, W, T_rows, C, n_rows);
}

// ---------------------------------------------------------------------------
// probe_gather_accum, mode 0: the one-hot product on the tensor cores
// ---------------------------------------------------------------------------

// x << s with PTX's clamp: 0 for any s >= 32 (s read as unsigned)
__device__ __forceinline__ uint32_t shl_clamp(uint32_t x, int s) {
  uint32_t v;
  asm("shl.b32 %0, %1, %2;" : "=r"(v) : "r"(x), "r"(s));
  return v;
}

// The A fragment of one m-tile at one 16-row k-step of the window, straight
// from the row ids: s0, s1 = 16 (r - w0 - 2t) for rows g and g+8 (r the
// row's id, negative or huge when it matches no column). A register holding
// columns c, c+1 is bf16 1.0 in the half whose column is r: 0x3F80 shifted
// by 16 (r - c) bits, which is 0 unless r - c is 0 or 1.
__device__ __forceinline__ void onehot_a(uint32_t (&a)[4], int s0, int s1) {
  a[0] = shl_clamp(0x3F80u, s0);
  a[1] = shl_clamp(0x3F80u, s1);
  a[2] = shl_clamp(0x3F80u, s0 - 128);   // columns c + 8, c + 9
  a[3] = shl_clamp(0x3F80u, s1 - 128);
}

// hi / mid / lo bf16 pairs of two f32 values (the low half the first)
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&p)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(hi), r1 = x1 - __high2float(hi);
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(r0 - __low2float(mid),
                                                  r1 - __high2float(mid));
  p[0] = *reinterpret_cast<const uint32_t*>(&hi);
  p[1] = *reinterpret_cast<const uint32_t*>(&mid);
  p[2] = *reinterpret_cast<const uint32_t*>(&lo);
}

template <typename T>
__global__ void __launch_bounds__(OneHot<T>::WARPS * 32, OneHot<T>::MIN_BLOCKS)
onehot_accum_kernel(const int32_t* __restrict__ rows,
                    const T* __restrict__ win, float* __restrict__ out, int K,
                    int W, int T_rows, int C, int64_t n_rows) {
  using G = OneHot<T>;
  constexpr int WARPS = G::WARPS, MT = G::MT, NP = G::COLS / 16;
  constexpr int ROWS = 16 * MT;        // output rows of a warp's item
  constexpr int VEC = Vec<T>::N;
  constexpr int NONE = -(1 << 24);     // s of an id that matches no column
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int W16 = (W + 15) & ~15;
  const int P = C + G::PAD;            // row pitch (elements)
  // the window, rows W .. W16-1 zero (0 x garbage would be NaN)
  const int ppr = C / VEC;
  for (int e = tid; e < W16 * ppr; e += WARPS * 32) {
    const int w = e / ppr, q = e - w * ppr;
    const bool ok = w < W;
    csn_tc::cp_async16(ws + (size_t)w * P + q * VEC,
                       win + (size_t)(ok ? w : 0) * C + q * VEC, ok);
  }
  csn_tc::cp_async_commit();
  csn_tc::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_chunks = (C + G::COLS - 1) / G::COLS;
  const int64_t items = (n_rows + ROWS - 1) / ROWS * n_chunks;
  // the items dealt to the blocks in turn
  for (int64_t it = (int64_t)warp * gridDim.x + blockIdx.x; it < items;
       it += (int64_t)gridDim.x * WARPS) {
    const int64_t grp = it / n_chunks;
    const int c0 = (int)(it - grp * n_chunks) * G::COLS;
    const int npair = min(G::COLS, C - c0) / 16;   // live 16-column pairs
    // the columns each pair reads: past C (a narrower last chunk) a live
    // pair's, whose sums are never stored
    int col[NP];
#pragma unroll
    for (int np = 0; np < NP; ++np) col[np] = min(c0 + np * 16, C - 16);
    // this lane's rows row0 + 8 rr (rr = 2 mt + h: m-tile mt, half h): their
    // row ids at base + off[rr] + k T (off -1: a row past n_rows)
    const int64_t row0 = grp * ROWS + g;
    const int64_t tile0 = min(row0, n_rows - 1) / T_rows;
    const int32_t* base = rows + tile0 * K * T_rows;
    int off[2 * MT];
#pragma unroll
    for (int rr = 0; rr < 2 * MT; ++rr) {
      int i = (int)(row0 - tile0 * T_rows) + 8 * rr, dt = 0;
      while (i >= T_rows) {
        i -= T_rows;
        ++dt;
      }
      off[rr] = row0 + 8 * rr < n_rows ? dt * K * T_rows + i : -1;
    }
    float acc[MT][2 * NP][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][n][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      // s = 16 (r - w0 - 2t) of each row at the current k-step w0
      int s[2 * MT];
#pragma unroll
      for (int rr = 0; rr < 2 * MT; ++rr) {
        const int r = off[rr] >= 0 ? __ldg(base + off[rr] + k * T_rows) : -1;
        s[rr] = r >= 0 && r < W ? 16 * (r - 2 * t) : NONE;
      }
      for (int w0 = 0; w0 < W16; w0 += 16) {
        if constexpr (sizeof(T) == 2) {
          // B: every pair's fragments first, then the products
          uint32_t b[NP][4];
#pragma unroll
          for (int np = 0; np < NP; ++np)
            csn_tc::ldsm_x4_t(b[np], ws + (w0 + (lane & 7) +
                                           ((lane >> 3) & 1) * 8) * P +
                                         col[np] + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            onehot_a(a, s[2 * mt], s[2 * mt + 1]);
#pragma unroll
            for (int np = 0; np < NP; ++np) {
              csn_tc::mma(acc[mt][2 * np], a, b[np][0], b[np][1]);
              csn_tc::mma(acc[mt][2 * np + 1], a, b[np][2], b[np][3]);
            }
          }
        } else {
          // B of a pair: rows w0 + 2t, +1, +8, +9 of column col + 8 half + g,
          // split into three bf16 parts, used by every m-tile
          const float* wf = reinterpret_cast<const float*>(ws) +
                            (w0 + 2 * t) * P + g;
#pragma unroll
          for (int np = 0; np < NP; ++np) {
            float x[2][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float* xp = wf + col[np] + half * 8;
              x[half][0] = xp[0];
              x[half][1] = xp[P];
              x[half][2] = xp[8 * P];
              x[half][3] = xp[9 * P];
            }
            uint32_t b0[2][3], b1[2][3];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              split3(x[half][0], x[half][1], b0[half]);
              split3(x[half][2], x[half][3], b1[half]);
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              uint32_t a[4];
              onehot_a(a, s[2 * mt], s[2 * mt + 1]);
#pragma unroll
              for (int half = 0; half < 2; ++half)
#pragma unroll
                for (int part = 0; part < 3; ++part)
                  csn_tc::mma(acc[mt][2 * np + half], a, b0[half][part],
                              b1[half][part]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2 * MT; ++rr) s[rr] -= 256;   // next k-step
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (off[2 * mt + h] < 0) continue;
        float* o = out + (row0 + 16 * mt + 8 * h) * C + c0 + 2 * t;
#pragma unroll
        for (int n = 0; n < 2 * NP; ++n)
          if (n / 2 < npair)
            __stcs(reinterpret_cast<float2*>(o + n * 8),
                   make_float2(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]));
      }
  }
}

template <typename T>
inline size_t onehot_smem(int W, int C) {
  return (size_t)((W + 15) & ~15) * (C + OneHot<T>::PAD) * sizeof(T);
}

template <typename T>
cudaError_t launch_accum(int mode, const void* rows, const void* win,
                         void* out, int K, int W, int T_rows, int C,
                         int64_t n_rows, int grid, cudaStream_t s) {
  const int32_t* r = static_cast<const int32_t*>(rows);
  const T* w = static_cast<const T*>(win);
  float* o = static_cast<float*>(out);
  if (mode == 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        onehot_accum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (attr != cudaSuccess) return attr;
    const size_t bytes = onehot_smem<T>(W, C);
    if (C % 16 != 0 || bytes > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
    onehot_accum_kernel<T><<<grid, OneHot<T>::WARPS * 32, bytes, s>>>(
        r, w, o, K, W, T_rows, C, n_rows);
  } else if (mode == 1) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        gather_smem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (attr != cudaSuccess) return attr;
    const size_t bytes = (size_t)W * C * sizeof(T);
    if (bytes > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
    gather_smem_kernel<T><<<grid, SMEM_THREADS, bytes, s>>>(
        r, w, o, K, W, T_rows, C, n_rows);
  } else if (mode == 2) {
    // no shared memory: the SM's 256 KB go to L1
    static const cudaError_t attr = cudaFuncSetAttribute(
        gather_global_kernel<T>,
        cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (attr != cudaSuccess) return attr;
    gather_global_kernel<T><<<grid, THREADS, 0, s>>>(r, w, o, K, W, T_rows, C,
                                                     n_rows);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// win [W, C] and out [T, C] of one type (f32 or bf16), rel [T] int32; C a
// multiple of 16 bytes' channels, win 16-byte aligned, slab a multiple of
// those channels.
extern "C" int csn_probe_window_gather(int dtype, int layout, const void* win,
                                       const void* rel, void* out, int W,
                                       int T, int C, int slab, void* stream) {
  if (T == 0 || C == 0) return cudaSuccess;
  const int es = dtype == csn::kF32 ? 4 : 2;
  if (W < 1 || slab < 1 || slab > 32 || (layout != 0 && layout != 1) ||
      (dtype != csn::kF32 && dtype != csn::kBF16) || (C * es) % 16 != 0 ||
      (slab * es) % 16 != 0 || !aligned16(win) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csn::kF32)
    return layout == 0
               ? launch_window<float, 0>(win, rel, out, W, T, C, slab, s)
               : launch_window<float, 1>(win, rel, out, W, T, C, slab, s);
  return layout == 0
             ? launch_window<bf16, 0>(win, rel, out, W, T, C, slab, s)
             : launch_window<bf16, 1>(win, rel, out, W, T, C, slab, s);
}

// rows [n_tiles * K, T] int32, win [W, C] f32 or bf16 (16-byte aligned, C a
// multiple of 16 bytes' channels; mode 0: of 16), out [n_tiles * T, C] f32;
// T a multiple of 8; `grid` persistent blocks.
extern "C" int csn_probe_gather_accum(int dtype, int mode, const void* rows,
                                      const void* win, void* out, int n_tiles,
                                      int K, int W, int T, int C, int grid,
                                      void* stream) {
  if (n_tiles == 0 || T == 0 || C == 0) return cudaSuccess;
  const int es = dtype == csn::kF32 ? 4 : 2;
  if (W < 1 || K < 1 || T % 8 != 0 || grid < 1 ||
      (dtype != csn::kF32 && dtype != csn::kBF16) || (C * es) % 16 != 0 ||
      !aligned16(win) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_rows = (int64_t)n_tiles * T;
  if (dtype == csn::kF32)
    return launch_accum<float>(mode, rows, win, out, K, W, T, C, n_rows, grid,
                               s);
  return launch_accum<bf16>(mode, rows, win, out, K, W, T, C, n_rows, grid, s);
}
