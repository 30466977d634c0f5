// Sparse convolution backward, weight gradient: dW_t[k] = feats^T . gather(g,
// kmap_t[k]) in f32.
//
// Replaces: the dW half of csn_tpu/core/window_conv.py window_conv_bwd
// (Pallas body _tile_bwd_kernel / _wjobs_bwd_kernel), which the JAX package
// reaches through the custom VJP of core/conv.py sparse_conv_tvjp. The other
// half, d_feats = sum_k gather(g, kmap_t[k]) . W_pair[k]^T, is a forward
// sparse conv over the transpose map and runs on the forward kernel
// (sparse_conv.cu) with the weights transposed.
//
// Computes, for offset k of the transpose map kmap_t [K, n_in] (entries
// outside [0, n_g), the sentinel n_g, add nothing):
//   dW_t[k][c][d] = sum_{n < n_in} feats[n][c] * g[kmap_t[k][n]][d],
// the identity of csn_tpu/core/conv.py:159-164 (each offset map is a partial
// permutation, so the forward's scatter of feats^T . g becomes this gather).
// Operands are read in the activation type, products accumulate in f32, and
// dW_t is stored in f32. The caller un-mirrors same-level maps (dW = dW_t
// reversed over k).
//
// Two kinds of body, chosen by dtype and shape by the rule of K1
// (sparse_conv.cu; window_conv.dw_tensor_cores; a failed launch returns its
// error, there is no retry on another body):
//  * Cout % 8 == 0, whatever Cin (every conv of the HRNet, Res16UNet,
//    ResUNet and ResNet families, the k5 stems' Cin 3 included): the
//    tensor-core bodies, over the live rows only, with f32 accumulators;
//    the wide body where Cin % 16 == 0, the narrow one (16-channel tiles)
//    elsewhere. bf16 runs mma.sync m16n8k16 on bf16 operands; f32 runs
//    mma.sync m16n8k8 on TF32 operands in split TF32, three products per
//    f32 product (flash_tf32.cuh), both operands split in registers as
//    their fragments are loaded;
//  * Cout % 8 != 0, either type: the CUDA-core body (f32 FMAs).
//
// What bounds it on the H100: the same 2*Cin*Cout operations per live (row,
// offset) pair as the forward; the bound counts each input byte once
// (chip_smoke.py conv_work). It is a reduction over up to 90112 rows per
// offset into a small [Cin, Cout] tile, so the level-0 convs (K tiles of
// 64x64) would leave most of the 132 SMs idle without a split of the rows;
// and most (row, offset) pairs are dead (same-level maps are about 26 %
// dense, up maps 7 %).
//
// Both bodies split the rows deterministically, with no atomics: block
// (channel tile, offset k, split s) reduces its share of the rows and
// stores its partial tile once; a second small kernel (common.cuh) sums the
// S partials [S, K, Cin, Cout] in the order s = 0, 1, ..., so two runs give
// the same bits. The caller picks S (csn_tpu_torch/core/window_conv.py
// dw_splits). The TPU kernel fused d_feats into the same pass over its VMEM
// windows; here d_feats, an output-stationary conv, and dW, an
// offset-stationary reduction, want different block shapes.
//
// Wide tensor-core design (Cin % 16 == 0, bf16 or f32). One block per
// (tile of 64 input channels, tile of BN = 64 WN output channels, offset k,
// split s), WN = ceil(Cout / 64) up to 4 as K1 picks it (a wider Cout takes
// several column tiles of equal width).
// Warps of 32 input x 64 output channels (2 x WN of them) hold 64 f32
// accumulators a lane over the whole split. The rows are the reduction
// axis, so dead rows are dropped and live ones packed densely:
//  1. The block walks its rows in chunks of CHUNK map entries. It reads a
//     chunk's kmap_t[k] entries (coalesced, RPT per lane per pass), finds
//     the live ones by a warp ballot, and appends their (feats row, g row)
//     pairs to a list in shared memory at positions from a prefix over the
//     warps' counts: row order, whatever the timing.
//  2. It walks the list in steps of STEP = 32 pairs. A step gathers the
//     pairs' feats rows (the tile's 64 channels) and g rows (BN channels)
//     by cp.async, 16 bytes at a time, into [STEP][64 + pad] and [STEP][BN
//     + pad] tiles, rows padded by 16 bytes (bf16: flash_tc.cuh's stride,
//     ldmatrix without bank conflicts; f32: strides of 4 words modulo 32,
//     so the fragments' 4-byte loads at pairs 2t, 2t + 1 and channel g hit
//     32 distinct banks); entries past the list's end, and channels past
//     Cin or Cout, are zero-filled. Two stages: the next step's copies are
//     issued right after the barrier that publishes this step's, before
//     its products.
//     Pairs short of a whole step wait for the next chunk (moved to the
//     list's front); the split's last step runs with a zero-filled tail.
//  3. bf16: per 16-row k-step a warp loads A = feats^T (M = its 32 input
//     channels, K = rows) by ldmatrix.trans of the [rows][Cin] tile, B by
//     ldmatrix.trans of the [rows][Cout] tile, and runs up to 16 mma.sync.
//     f32: per 8-row k-step a warp loads and splits its two A fragments
//     (four 4-byte loads each) and one B fragment at a time (two), and runs
//     2 x 3 mma.sync per 8 output channels, the small products first.
//     Channel blocks past Cin or Cout are skipped.
// A split with no live row does no products and stores zeros. wgmma and TMA
// are later work.
//
// Narrow tensor-core design (Cin % 16 != 0: the stems, 3 -> 32 over 125
// offsets; bf16, or f32 in split TF32). What bounds it is not the products
// (0.36 GFLOP at HRNet's stem) but the bytes and their latency: the [125,
// N] int32 map read once (45 MB at 90112 rows, the floor), and per live
// pair a 64- or 128-byte g row gathered (from L2: g is 5.8 or 11.5 MB) and
// a 6- or 12-byte feats row. The body keeps the wide one's scheme and cuts
// what a 3-channel tile does not need. One block of 4 warps per (tile of
// 16 input channels, tile of 32 output channels, or 64 past Cout 32,
// offset k, split s):
//  1. Chunks of CHUNK map entries, one compaction pass each (8 per lane,
//     the wide body's ballots and prefix). The next chunk's entries are
//     read into registers right after a chunk's compaction and looked at
//     only in the next one, so their latency hides behind the chunk's
//     gathers.
//  2. Tiles of NTILE = 256 live pairs, gathered at once: every g row by
//     cp.async into one [256][BN + pad] tile (rows 16 bytes past BN), and
//     beside it each lane's A fragments (A = feats^T, M = one m16 tile of
//     channels, 13 of its 16 rows zero at Cin 3): feats rows of Cin 3 are
//     6 or 12 bytes, too short for a 16-byte copy, so each lane loads its
//     own values element by element into registers, zero past Cin and past
//     the list's end. No feats tile, no ldmatrix for A; at Cin <= 8 the
//     registers of channels 8-15 are known zeros, neither loaded nor kept
//     (C8). One wait and two barriers per tile; each warp runs 4 k16 steps
//     (bf16) or 8 k8 steps (f32) of it. f32: per k8 step a warp splits its
//     A fragment in registers and each B fragment (two 4-byte loads of the
//     [256][BN + 4]-word tile at pairs 2t, 2t + 1 and channel g, 32
//     distinct banks) as it is loaded, runs 3 mma.sync per 8 output
//     channels, the small products first, into a fragment that starts at
//     zero every tile and is added to the running sum in f32 (the tensor
//     cores truncate every mma.sync's sum). Pairs short of a tile wait for
//     the next chunk, as in the wide body. (Measured no faster in bf16:
//     two 64-pair stages; a ring that keeps a tile in flight across the
//     next compaction; chunks of 2048 or 4096 entries.)
//  3. Each warp holds a 16 x BN partial over its pairs; at the split's end
//     the four are added in warp order through shared memory and stored
//     once: the same bits on every run.
// The splits (window_conv.dw_splits) matter more than the tile: the blocks
// wait on latency, not on a unit, so more and shorter splits fill the
// card; 26 measured best at both stems, in bf16 and in f32
// (csn_tpu_torch/tools/stem_splits.py).
//
// CUDA-core design (Cout % 8 != 0). One block per
// (tile of TM input channels x 64 output channels, offset, split) walks its
// rows in chunks of 16: it stages the chunk's kmap_t entries, skips the
// chunk when all are sentinels, loads the feats rows and the gathered g
// rows into shared memory in f32, and each of the 256 threads accumulates
// a (TM/16) x 4 register tile. TM is 16 for Cin <= 16 (so 3 of 16 rows of
// the tile, not 3 of 64, are padding) and 64 otherwise.

#include <type_traits>

#include "common.cuh"
#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace {

constexpr int BN = 64;   // output channels per tile
constexpr int BR = 16;   // rows per chunk
constexpr int THREADS = 256;

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
sparse_conv_dw_kernel(const T* __restrict__ feats, const T* __restrict__ g,
                      const int32_t* __restrict__ kmap_t,
                      float* __restrict__ part, int64_t n_in, int64_t n_g,
                      int n_off, int cin, int cout, int64_t rows_per_split) {
  constexpr int MI = TM / 16;  // input channels per thread
  __shared__ __align__(16) float As[BR][TM];  // feats rows
  __shared__ __align__(16) float Bs[BR][BN];  // gathered g rows
  __shared__ int64_t grow[BR];                // g row per feats row, or -1

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // input channels ty*MI .. ty*MI+MI-1
  const int n_tiles = (cout + BN - 1) / BN;
  const int c0 = (blockIdx.x / n_tiles) * TM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int k = blockIdx.y;
  const int s = blockIdx.z;
  const int64_t r_begin = (int64_t)s * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < n_in ? r_begin + rows_per_split : n_in;
  const int32_t* km = kmap_t + (int64_t)k * n_in;

  float acc[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += BR) {
    int live = 0;
    if (tid < BR) {
      const int64_t r = r0 + tid;
      int64_t gi = -1;
      if (r < r_end) {
        const int64_t v = km[r];
        if (v >= 0 && v < n_g) gi = v;
      }
      grow[tid] = gi;
      live = gi >= 0;
    }
    // also the barrier that publishes grow[] and orders the previous
    // chunk's reads of As/Bs before these writes
    if (!__syncthreads_or(live)) continue;

    for (int e = tid; e < BR * TM; e += THREADS) {
      const int r = e / TM, m = e % TM;
      const int c = c0 + m;
      As[r][m] = (grow[r] >= 0 && c < cin)
                     ? csn::to_f32(feats[(r0 + r) * cin + c])
                     : 0.f;
    }
    for (int e = tid; e < BR * BN; e += THREADS) {
      const int r = e / BN, nn = e % BN;
      const int n = n0 + nn;
      const int64_t gi = grow[r];
      Bs[r][nn] = (gi >= 0 && n < cout) ? csn::to_f32(g[gi * cout + n]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < BR; ++r) {
      float av[MI];
      if constexpr (MI == 4) {
        const float4 a = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
        av[0] = a.x;
        av[1] = a.y;
        av[2] = a.z;
        av[3] = a.w;
      } else {
#pragma unroll
        for (int i = 0; i < MI; ++i) av[i] = As[r][ty * MI + i];
      }
      const float4 b = *reinterpret_cast<const float4*>(&Bs[r][tx * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* out = part + ((int64_t)s * n_off + k) * cin * cout;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int c = c0 + ty * MI + i;
    if (c >= cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < cout) out[(int64_t)c * cout + n] = acc[i][j];
    }
  }
}

template <typename T, int TM>
cudaError_t launch(const void* feats, const void* g, const void* kmap_t,
                   float* dst, int64_t n_in, int64_t n_g, int n_off, int cin,
                   int cout, int n_split, int64_t rows_per_split,
                   cudaStream_t stream) {
  const unsigned tiles =
      (unsigned)(((cin + TM - 1) / TM) * ((cout + BN - 1) / BN));
  const dim3 grid(tiles, (unsigned)n_off, (unsigned)n_split);
  sparse_conv_dw_kernel<T, TM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(g),
      static_cast<const int32_t*>(kmap_t), dst, n_in, n_g, n_off, cin, cout,
      rows_per_split);
  return cudaGetLastError();
}

// --- the tensor-core bodies (bf16 or f32 with Cout % 8 == 0) ---------------

using csn_tc::bf16;
using csn_tc::cp_async16;
using csn_tc::cp_async_commit;
using csn_tc::cp_async_wait;
using csn_tc::ldsm_x4_t;
using csn_tc::load_a_t;
using csn_tc::mma;

constexpr int CHUNK = 1024;     // map entries compacted per refill of the list

// The wide body (Cin % 16 == 0): channel tiles of 64, bf16 or f32.

constexpr int TBM = 64;         // input channels per tile
constexpr int STEP = 32;        // live rows per step (the products' K)

template <typename T, int WN>
struct DwTile {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int BN = 64 * WN;         // output channels
  static constexpr int THREADS = 64 * WN;    // 2 x WN warps of 32 x 64
  static constexpr int NWARPS = THREADS / 32;
  static constexpr int RPT = WN >= 4 ? 2 : 8 / WN;  // map entries per lane
  static constexpr int PASS = THREADS * RPT;        // per compaction pass
  static constexpr int VEC = 16 / sizeof(T);        // elements per copy
  // row strides 16 bytes past the row: bf16 flash_tc.cuh's LDS (ldmatrix
  // without bank conflicts); f32 4 words modulo 32 (the split-TF32
  // fragments' 4-byte loads at rows 2t, 2t + 1 and column g, 32 banks)
  static constexpr int LDA = TBM + VEC;      // feats tile row stride
  static constexpr int LDB = BN + VEC;       // g tile row stride
  static constexpr int A_ELEMS = STEP * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + STEP * LDB;
  static constexpr int LIST = CHUNK + STEP;  // a chunk + what a step left
  // two stages, the list's feats rows and g rows, the warps' counts
  static constexpr size_t SMEM =
      sizeof(T) * 2 * STAGE_ELEMS + sizeof(int32_t) * (2 * LIST + NWARPS);
  // blocks per SM the registers are sized for: bf16 8 / WN (2 from WN 3);
  // f32 what its shared memory lets in (about 43, 60, 76 and 92 KB a
  // block), so that at WN 1-3 the split operands fit in registers (WN 4's
  // two blocks of 256 threads cap it at 128 and spill a few bytes)
  static constexpr int MIN_BLOCKS =
      F32 ? (WN == 1 ? 4 : WN == 2 ? 3 : 2) : (WN >= 3 ? 2 : 8 / WN);
};
static_assert(DwTile<bf16, 1>::LDA == csn_tc::LDS,
              "load_a_t reads rows LDS elements apart");

template <typename T, int WN>
__global__ void __launch_bounds__(64 * WN, DwTile<T, WN>::MIN_BLOCKS)
sparse_conv_dw_tc_kernel(const T* __restrict__ feats,
                         const T* __restrict__ g,
                         const int32_t* __restrict__ kmap_t,
                         float* __restrict__ part, int64_t n_in, int64_t n_g,
                         int n_off, int cin, int cout,
                         int64_t rows_per_split) {
  using Tl = DwTile<T, WN>;
  constexpr int BN = Tl::BN, THREADS = Tl::THREADS, NWARPS = Tl::NWARPS;
  constexpr int RPT = Tl::RPT, VEC = Tl::VEC, LDA = Tl::LDA, LDB = Tl::LDB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  int32_t* lf = reinterpret_cast<int32_t*>(stages + 2 * Tl::STAGE_ELEMS);
  int32_t* lg = lf + Tl::LIST;
  int32_t* wcnt = lg + Tl::LIST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int n_tiles = (cout + BN - 1) / BN;
  const int c0 = (blockIdx.x / n_tiles) * TBM;   // the tile's input channels
  const int n0 = (blockIdx.x % n_tiles) * BN;    // and output channels
  const int k = blockIdx.y, s = blockIdx.z;
  const int64_t r_begin = (int64_t)s * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < n_in ? r_begin + rows_per_split : n_in;
  const int32_t* km = kmap_t + (int64_t)k * n_in;

  // 1. append the live pairs of rows [a, b) to the list after its n
  // entries, in row order; returns the new count. Two barriers per pass;
  // the last one publishes the list.
  auto compact = [&](int64_t a, int64_t b, int n) {
    for (int64_t p = a; p < b; p += Tl::PASS) {
      int32_t v[RPT];
      unsigned bal[RPT];
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int64_t r = p + (int64_t)(warp * RPT + j) * 32 + lane;
        int32_t x = -1;
        if (r < b) {
          const int32_t y = __ldg(km + r);
          if (y >= 0 && y < n_g) x = y;
        }
        v[j] = x;
        bal[j] = __ballot_sync(0xffffffffu, x >= 0);
        cnt += __popc(bal[j]);
      }
      if (lane == 0) wcnt[warp] = cnt;
      __syncthreads();
      int pos = n;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const int c = wcnt[w];
        pos += w < warp ? c : 0;
        n += c;
      }
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (v[j] >= 0) {
          const int q = pos + __popc(bal[j] & below);
          lf[q] = (int32_t)(p + (int64_t)(warp * RPT + j) * 32 + lane);
          lg[q] = v[j];
        }
        pos += __popc(bal[j]);
      }
      __syncthreads();  // the counts are rewritten by the next pass
    }
    return n;
  };

  // 2. the copies of the step at list entry e0 (of n) into stage st
  auto load = [&](int st, int e0, int n) {
    T* as = stages + st * Tl::STAGE_ELEMS;
    T* bs = as + Tl::A_ELEMS;
#pragma unroll
    for (int i = tid; i < STEP * (TBM / VEC); i += THREADS) {
      const int r = i / (TBM / VEC), c = (i % (TBM / VEC)) * VEC;
      const bool ok = e0 + r < n && c0 + c < cin;
      cp_async16(as + r * LDA + c,
                 feats + (ok ? (int64_t)lf[e0 + r] * cin + c0 + c : 0), ok);
    }
#pragma unroll
    for (int i = tid; i < STEP * (BN / VEC); i += THREADS) {
      const int r = i / (BN / VEC), c = (i % (BN / VEC)) * VEC;
      const bool ok = e0 + r < n && n0 + c < cout;
      cp_async16(bs + r * LDB + c,
                 g + (ok ? (int64_t)lg[e0 + r] * cout + n0 + c : 0), ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  const int cm = c0 + 32 * wm;   // the warp's first input channel
  const int wc = n0 + 64 * wn;   // and output channel
  const int mi = cm < cin ? min(2, (cin - cm) / 16) : 0;  // 16-channel blocks
  const int gr = lane >> 2, t = lane & 3;

  // 3. the products of the step in stage st: A = feats^T (M = the warp's
  // input channels, K = the step's pairs), B = the gathered g rows
  auto compute = [&](int st) {
    if (mi == 0 || wc >= cout) return;
    const T* as = stages + st * Tl::STAGE_ELEMS;
    const T* bs = as + Tl::A_ELEMS;
    if constexpr (Tl::F32) {
      // split TF32 (flash_tf32.cuh), k-steps of 8 pairs: A's fragment
      // (channel g (+8), pair 2t (+1)) and B's (pair 2t (+1), channel g)
      // are 4-byte loads of the [pairs][channels] tiles, split in registers
#pragma unroll
      for (int ks = 0; ks < STEP / 8; ++ks) {
        csn_tf32::FragA a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i >= mi) break;
          const float* p = as + (ks * 8 + 2 * t) * LDA + 32 * wm + 16 * i + gr;
          csn_tf32::split(p[0], a[i].hi[0], a[i].lo[0]);
          csn_tf32::split(p[8], a[i].hi[1], a[i].lo[1]);
          csn_tf32::split(p[LDA], a[i].hi[2], a[i].lo[2]);
          csn_tf32::split(p[LDA + 8], a[i].hi[3], a[i].lo[3]);
        }
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          if (wc + 8 * nb >= cout) break;
          const float* q = bs + (ks * 8 + 2 * t) * LDB + 64 * wn + 8 * nb + gr;
          csn_tf32::FragB b;
          csn_tf32::split(q[0], b.hi[0], b.lo[0]);
          csn_tf32::split(q[LDB], b.hi[1], b.lo[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < mi) csn_tf32::mma_tf32(acc[i][nb], a[i].lo, b.hi);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < mi) csn_tf32::mma_tf32(acc[i][nb], a[i].hi, b.lo);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < mi) csn_tf32::mma_tf32(acc[i][nb], a[i].hi, b.hi);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < STEP / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (i < mi) load_a_t(a[i], as, 32 * wm + 16 * i, ks, lane);
#pragma unroll
        for (int nb2 = 0; nb2 < 4; ++nb2) {
          if (wc + 16 * nb2 >= cout) break;
          uint32_t b[4];
          ldsm_x4_t(b, bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LDB +
                           64 * wn + nb2 * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (i >= mi) break;
            mma(acc[i][2 * nb2], a[i], b[0], b[1]);
            mma(acc[i][2 * nb2 + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
  };

  int n = 0;  // pairs in the list
  for (int64_t a = r_begin; a < r_end; a += CHUNK) {
    const int64_t b = a + CHUNK < r_end ? a + CHUNK : r_end;
    n = compact(a, b, n);
    const bool last = b >= r_end;
    const int steps = last ? (n + STEP - 1) / STEP : n / STEP;
    // one barrier per step, which publishes its tiles and orders every
    // warp's reads of the other stage before its next copy
    if (steps > 0) load(0, 0, n);
    cp_async_commit();
    for (int i = 0; i < steps; ++i) {
      cp_async_wait<0>();
      __syncthreads();
      if (i + 1 < steps) load((i + 1) & 1, (i + 1) * STEP, n);
      cp_async_commit();
      compute(i & 1);
    }
    cp_async_wait<0>();
    // every warp is done with the stages and with the list's used entries
    __syncthreads();
    // the pairs short of a step go to the front (a step took STEP > rest
    // entries, so the two ranges are disjoint); the next compaction writes
    // after them only past its first barrier
    const int used = steps * STEP;
    const int rest = last ? 0 : n - used;
    if (used > 0)
      for (int e = tid; e < rest; e += THREADS) {
        lf[e] = lf[used + e];
        lg[e] = lg[used + e];
      }
    n = rest;
  }

  float* out = part + ((int64_t)s * n_off + k) * cin * cout;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = cm + 16 * i + gr + 8 * h;
      if (c >= cin) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wc + 8 * j + 2 * t;
        if (col < cout)
          *reinterpret_cast<float2*>(out + (int64_t)c * cout + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

template <typename T, int WN>
cudaError_t launch_tc_body(const void* feats, const void* g,
                           const void* kmap_t, float* dst, int64_t n_in,
                           int64_t n_g, int n_off, int cin, int cout,
                           int n_split, int64_t rows_per_split,
                           cudaStream_t stream) {
  using Tl = DwTile<T, WN>;
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_conv_dw_tc_kernel<T, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned tiles =
      (unsigned)(((cin + TBM - 1) / TBM) * ((cout + Tl::BN - 1) / Tl::BN));
  const dim3 grid(tiles, (unsigned)n_off, (unsigned)n_split);
  sparse_conv_dw_tc_kernel<T, WN><<<grid, Tl::THREADS, Tl::SMEM, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(g),
      static_cast<const int32_t*>(kmap_t), dst, n_in, n_g, n_off, cin, cout,
      rows_per_split);
  return cudaGetLastError();
}

// BN = 64 WN by K1's rule: one column tile up to Cout 256, else
// ceil(Cout / 256) tiles of equal width
template <typename T>
cudaError_t launch_tc(const void* feats, const void* g, const void* kmap_t,
                      float* dst, int64_t n_in, int64_t n_g, int n_off,
                      int cin, int cout, int n_split, int64_t rows_per_split,
                      cudaStream_t stream) {
  const int n64 = (cout + 63) / 64;
  const int tiles = (n64 + 3) / 4;
  const int wn = (n64 + tiles - 1) / tiles;
#define CSN_TC(WN)                                                         \
  return launch_tc_body<T, WN>(feats, g, kmap_t, dst, n_in, n_g, n_off, cin, \
                               cout, n_split, rows_per_split, stream)
  if (wn == 1) CSN_TC(1);
  if (wn == 2) CSN_TC(2);
  if (wn == 3) CSN_TC(3);
  CSN_TC(4);
#undef CSN_TC
}

// The narrow body (Cin % 16 != 0: the k5 stems' Cin 3): channel tiles of 16,
// bf16 or f32.

constexpr int NW = 4;                   // warps of a block
constexpr int NTHREADS = 32 * NW;
constexpr int NTILE = 256;              // live pairs gathered at once
constexpr int NRPT = CHUNK / NTHREADS;  // map entries per lane: a chunk a pass
constexpr int NLIST = CHUNK + NTILE;    // a chunk + what a tile left
static_assert(NRPT * NTHREADS == CHUNK, "one compaction pass per chunk");

// The narrow body's k-steps: KS pairs each (bf16 m16n8k16, f32 m16n8k8 in
// split TF32), NKS of them per warp and tile; elements per 16-byte copy VEC
// (also the g tile's row padding: rows 16 bytes past BN, bf16 flash_tc.cuh's
// stride for ldmatrix; f32 4 words modulo 32, so the B fragments' 4-byte
// loads at pairs 2t, 2t + 1 and channel g hit 32 distinct banks); H values
// of a pair per A register (bf16 two pairs, f32 one).
template <typename T>
struct NarrowType;
template <>
struct NarrowType<bf16> {
  static constexpr int KS = 16, VEC = 8, H = 2;
};
template <>
struct NarrowType<float> {
  static constexpr int KS = 8, VEC = 4, H = 1;
};

// The narrow body's compaction: the wide body's (its step 1), split in two
// so that a chunk's map loads are in flight during the previous chunk's
// tiles.

// Map entries p + (warp * NRPT + j) * 32 + lane of a chunk (rows before b;
// -1 past b). A warp's loads of one j are 128 contiguous bytes.
// The values are not looked at here, so the loads stay in flight until
// append_live needs them.
__device__ __forceinline__ void read_map(int32_t (&v)[NRPT],
                                         const int32_t* __restrict__ km,
                                         int64_t p, int64_t b, int warp,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < NRPT; ++j) {
    const int64_t r = p + (int64_t)(warp * NRPT + j) * 32 + lane;
    v[j] = r < b ? __ldg(km + r) : -1;
  }
}

// Appends the live pairs (feats row, g row) among a chunk's entries v
// (read_map at row p; live: inside [0, n_g), not the sentinel) to the list
// lf / lg after its n entries, at positions from a prefix over the warps'
// counts: row order, whatever the timing. Returns the new count. Every
// thread of the block calls it; two barriers, the last of which publishes
// the list.
__device__ __forceinline__ int append_live(const int32_t (&v)[NRPT],
                                           int64_t p, int64_t n_g, int n,
                                           int32_t* lf, int32_t* lg,
                                           int32_t* wcnt, int warp,
                                           int lane) {
  bool ok[NRPT];
  unsigned bal[NRPT];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < NRPT; ++j) {
    ok[j] = v[j] >= 0 && v[j] < n_g;
    bal[j] = __ballot_sync(0xffffffffu, ok[j]);
    cnt += __popc(bal[j]);
  }
  if (lane == 0) wcnt[warp] = cnt;
  __syncthreads();
  int pos = n;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int c = wcnt[w];
    pos += w < warp ? c : 0;
    n += c;
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < NRPT; ++j) {
    if (ok[j]) {
      const int q = pos + __popc(bal[j] & below);
      lf[q] = (int32_t)(p + (int64_t)(warp * NRPT + j) * 32 + lane);
      lg[q] = v[j];
    }
    pos += __popc(bal[j]);
  }
  __syncthreads();  // the counts are rewritten by the next chunk
  return n;
}

// NB: 8-column blocks of the block's output channels
template <typename T, int NB>
struct NarrowTile {
  static constexpr int KS = NarrowType<T>::KS, VEC = NarrowType<T>::VEC;
  static constexpr int NKS = NTILE / (KS * NW);  // k-steps of a warp per tile
  static constexpr int BN = 8 * NB, LDB = BN + VEC;
  // the g tile [NTILE][LDB] (at the end the warps' sums), the list's feats
  // rows and g rows, the warps' counts
  static constexpr size_t SMEM = sizeof(T) * NTILE * LDB +
                                 sizeof(int32_t) * (2 * NLIST + NW);
  static_assert(NKS * KS * NW == NTILE, "whole k-steps per tile");
  static_assert(NW * 16 * BN * sizeof(float) <= NTILE * LDB * sizeof(T),
                "the warps' sums fit in the g tile");
};

// C8: Cin <= 8, so the A fragments' registers of channels 8-15 (a1, a3)
// are zeros the body neither loads nor keeps
template <typename T, int NB, bool C8>
__global__ void __launch_bounds__(NTHREADS)
sparse_conv_dw_narrow_kernel(const T* __restrict__ feats,
                             const T* __restrict__ g,
                             const int32_t* __restrict__ kmap_t,
                             float* __restrict__ part, int64_t n_in,
                             int64_t n_g, int n_off, int cin, int cout,
                             int64_t rows_per_split) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using Tl = NarrowTile<T, NB>;
  constexpr int BN = Tl::BN, LDB = Tl::LDB, VEC = Tl::VEC, KS = Tl::KS;
  constexpr int NKS = Tl::NKS, H = NarrowType<T>::H;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* gs = reinterpret_cast<T*>(smem_raw);  // g rows [NTILE][LDB]
  int32_t* lf = reinterpret_cast<int32_t*>(gs + NTILE * LDB);
  int32_t* lg = lf + NLIST;
  int32_t* wcnt = lg + NLIST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int n_tiles = (cout + BN - 1) / BN;
  const int c0 = (blockIdx.x / n_tiles) * 16;  // the tile's input channels
  const int n0 = (blockIdx.x % n_tiles) * BN;  // and output channels
  const int k = blockIdx.y, s = blockIdx.z;
  const int64_t r_begin = (int64_t)s * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < n_in ? r_begin + rows_per_split : n_in;
  const int32_t* km = kmap_t + (int64_t)k * n_in;

  // the g rows of the tile at list entry e0 (of n)
  auto load_g = [&](int e0, int n) {
#pragma unroll
    for (int i = tid; i < NTILE * (BN / VEC); i += NTHREADS) {
      const int r = i / (BN / VEC), c = (i % (BN / VEC)) * VEC;
      const bool ok = e0 + r < n && n0 + c < cout;
      cp_async16(gs + r * LDB + c,
                 g + (ok ? (int64_t)lg[e0 + r] * cout + n0 + c : 0), ok);
    }
  };
  // the feats values of the warp's A fragments (A = feats^T: M the tile's 16
  // channels, K the pairs of k-step ks, e0 + KS (NW ks + warp) .. + KS - 1):
  // x[ks][i][h] is channel c0 + gr + 8 (i & 1) of pair 2t + h + 8 (i >> 1)
  // (bf16: half h of register i) or of pair 2t + (i >> 1) (f32,
  // flash_tf32.cuh's layout); zero past Cin and past the list's end. Loaded
  // beside the tile's g copies, used after its barrier.
  T x[NKS][4][H];
  auto load_feats = [&](int e0, int n) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int c = c0 + gr + 8 * (i & 1);
          const int q = e0 + KS * (NW * ks + warp) + 2 * t +
                        (F32 ? i >> 1 : 8 * (i >> 1) + h);
          if constexpr (F32)
            x[ks][i][h] = 0.f;
          else
            x[ks][i][h] = __float2bfloat16(0.f);
          if ((!C8 || (i & 1) == 0) && c < cin && q < n)
            x[ks][i][h] = feats[(int64_t)lf[q] * cin + c];
        }
  };

  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // the products of the warp's k-steps of the tile
  auto compute = [&]() {
    if constexpr (F32) {
      // split TF32: the tile's 3 NKS products per 8 output channels go into
      // a fresh fragment, added to the running sum in f32 (the tensor cores
      // truncate each mma.sync's sum)
      float tile[NB][4] = {};
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        csn_tf32::FragA a;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (C8 && (i & 1)) {
            a.hi[i] = a.lo[i] = 0u;
            continue;
          }
          csn_tf32::split(x[ks][i][0], a.hi[i], a.lo[i]);
        }
        const float* q = gs + (KS * (NW * ks + warp) + 2 * t) * LDB + gr;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (n0 + 8 * j >= cout) break;
          csn_tf32::FragB b;
          csn_tf32::split(q[8 * j], b.hi[0], b.lo[0]);
          csn_tf32::split(q[LDB + 8 * j], b.hi[1], b.lo[1]);
          csn_tf32::mma_tf32(tile[j], a.lo, b.hi);
          csn_tf32::mma_tf32(tile[j], a.hi, b.lo);
          csn_tf32::mma_tf32(tile[j], a.hi, b.hi);
        }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += tile[j][e];
    } else {
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        uint32_t a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 p =
              __halves2bfloat162(x[ks][i][0], x[ks][i][1]);
          a[i] = *reinterpret_cast<const uint32_t*>(&p);
        }
        const int r0 = KS * (NW * ks + warp);
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
          if (n0 + 16 * nb2 >= cout) break;
          uint32_t b[4];
          ldsm_x4_t(b, gs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                           nb2 * 16 + (lane >> 4) * 8);
          mma(acc[2 * nb2], a, b[0], b[1]);
          mma(acc[2 * nb2 + 1], a, b[2], b[3]);
        }
      }
    }
  };

  // the end of the chunk that starts at row a
  auto chunk_end = [&](int64_t a) {
    return a + CHUNK < r_end ? a + CHUNK : r_end;
  };
  int32_t v[NRPT];
  if (r_begin < r_end) read_map(v, km, r_begin, chunk_end(r_begin), warp, lane);
  int n = 0;  // pairs in the list
  for (int64_t a = r_begin; a < r_end; a += CHUNK) {
    const int64_t b = chunk_end(a);
    n = append_live(v, a, n_g, n, lf, lg, wcnt, warp, lane);
    // the next chunk's map entries are in flight during this chunk's tiles
    if (b < r_end) read_map(v, km, b, chunk_end(b), warp, lane);
    const bool last = b >= r_end;
    const int tiles = last ? (n + NTILE - 1) / NTILE : n / NTILE;
    // two barriers per tile: after its copies, and before the next tile's
    for (int i = 0; i < tiles; ++i) {
      load_g(i * NTILE, n);
      cp_async_commit();
      load_feats(i * NTILE, n);
      cp_async_wait<0>();
      __syncthreads();
      compute();
      __syncthreads();
    }
    // the pairs short of a tile go to the front (a tile took NTILE > rest
    // entries, so the two ranges are disjoint); the next compaction writes
    // after them only past its first barrier
    const int used = tiles * NTILE;
    const int rest = last ? 0 : n - used;
    if (used > 0)
      for (int e = tid; e < rest; e += NTHREADS) {
        lf[e] = lf[used + e];
        lg[e] = lg[used + e];
      }
    n = rest;
  }

  // the warps' sums over their pairs, added in warp order (the g tile is
  // free: a barrier follows every read of it)
  float* red = reinterpret_cast<float*>(gs);  // [NW][16][BN]
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(red + (warp * 16 + gr + 8 * h) * BN + 8 * j +
                                 2 * t) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  __syncthreads();
  float* out = part + ((int64_t)s * n_off + k) * cin * cout;
  for (int i = tid; i < 16 * BN; i += NTHREADS) {
    const int c = c0 + i / BN, col = n0 + i % BN;
    if (c < cin && col < cout) {
      float sum = red[i];
#pragma unroll
      for (int w = 1; w < NW; ++w) sum += red[w * 16 * BN + i];
      out[(int64_t)c * cout + col] = sum;
    }
  }
}

template <typename T, int NB, bool C8>
cudaError_t launch_narrow_body(const void* feats, const void* g,
                               const void* kmap_t, float* dst, int64_t n_in,
                               int64_t n_g, int n_off, int cin, int cout,
                               int n_split, int64_t rows_per_split,
                               cudaStream_t stream) {
  using Tl = NarrowTile<T, NB>;
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_conv_dw_narrow_kernel<T, NB, C8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned tiles =
      (unsigned)(((cin + 15) / 16) * ((cout + Tl::BN - 1) / Tl::BN));
  const dim3 grid(tiles, (unsigned)n_off, (unsigned)n_split);
  sparse_conv_dw_narrow_kernel<T, NB, C8>
      <<<grid, NTHREADS, Tl::SMEM, stream>>>(
          static_cast<const T*>(feats), static_cast<const T*>(g),
          static_cast<const int32_t*>(kmap_t), dst, n_in, n_g, n_off, cin,
          cout, rows_per_split);
  return cudaGetLastError();
}

// 32 output channels per block up to Cout 32 (the stems), else 64
template <typename T>
cudaError_t launch_narrow(const void* feats, const void* g,
                          const void* kmap_t, float* dst, int64_t n_in,
                          int64_t n_g, int n_off, int cin, int cout,
                          int n_split, int64_t rows_per_split,
                          cudaStream_t stream) {
#define CSN_NARROW(NB, C8)                                                \
  return launch_narrow_body<T, NB, C8>(feats, g, kmap_t, dst, n_in, n_g, \
                                       n_off, cin, cout, n_split,         \
                                       rows_per_split, stream)
  if (cout <= 32) {
    if (cin <= 8) CSN_NARROW(4, true);
    CSN_NARROW(4, false);
  }
  if (cin <= 8) CSN_NARROW(8, true);
  CSN_NARROW(8, false);
#undef CSN_NARROW
}

}  // namespace

// feats [n_in, cin] and g [n_g, cout] of one type, kmap_t [n_off, n_in]
// int32 (sentinel n_g), part [n_split, n_off, cin, cout] f32 scratch
// (unused when n_split == 1), out [n_off, cin, cout] f32. The tensor-core
// bodies copy g, and feats where Cin % 16 == 0, 16 bytes at a time: those
// start on a 16-byte boundary.
extern "C" int csn_sparse_conv_dw(int dtype, const void* feats, const void* g,
                                  const void* kmap_t, void* part, void* out,
                                  int64_t n_in, int64_t n_g, int n_off,
                                  int cin, int cout, int n_split,
                                  void* stream) {
  if (n_off == 0 || cin == 0 || cout == 0) return cudaSuccess;
  if (n_split < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = (n_in + n_split - 1) / n_split;
  // one split writes the result directly
  float* dst = static_cast<float*>(n_split == 1 ? out : part);
  const bool tm16 = cin <= 16;  // the CUDA-core body's channel tile
  const bool wide = cin % 16 == 0;
  cudaError_t err;
  if (dtype == csn::kBF16 && cout % 8 == 0)
    err = wide ? launch_tc<bf16>(feats, g, kmap_t, dst, n_in, n_g, n_off, cin,
                                 cout, n_split, rows, s)
               : launch_narrow<bf16>(feats, g, kmap_t, dst, n_in, n_g, n_off,
                                     cin, cout, n_split, rows, s);
  else if (dtype == csn::kF32 && cout % 8 == 0)
    err = wide ? launch_tc<float>(feats, g, kmap_t, dst, n_in, n_g, n_off,
                                  cin, cout, n_split, rows, s)
               : launch_narrow<float>(feats, g, kmap_t, dst, n_in, n_g,
                                      n_off, cin, cout, n_split, rows, s);
  else if (dtype == csn::kF32)
    err = tm16 ? launch<float, 16>(feats, g, kmap_t, dst, n_in, n_g, n_off,
                                   cin, cout, n_split, rows, s)
               : launch<float, 64>(feats, g, kmap_t, dst, n_in, n_g, n_off,
                                   cin, cout, n_split, rows, s);
  else if (dtype == csn::kBF16)
    err = tm16 ? launch<__nv_bfloat16, 16>(feats, g, kmap_t, dst, n_in,
                                           n_g, n_off, cin, cout, n_split,
                                           rows, s)
               : launch<__nv_bfloat16, 64>(feats, g, kmap_t, dst, n_in, n_g,
                                           n_off, cin, cout, n_split, rows,
                                           s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || n_split == 1) return err;
  const int64_t n = (int64_t)n_off * cin * cout;
  csn::sum_splits_kernel<THREADS>
      <<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
          static_cast<const float*>(part), static_cast<float*>(out), n,
          n_split);
  return cudaGetLastError();
}
