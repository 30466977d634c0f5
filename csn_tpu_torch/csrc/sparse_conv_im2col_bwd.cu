// Sparse convolution backward in im2col form: one gather of the output
// gradient over the transpose map feeds both gradients.
//
// Replaces: csn_tpu/core/window_conv.py window_conv_bwd in the modes
// CSN_DYNG=2/3 (Pallas body _tile_bwd_im2col_kernel), which the JAX package
// reaches through the custom VJP of core/conv.py sparse_conv_tvjp.
//
// With GG[n][k*Cout + d] = g[kmap_t[k, n]][d] for n < n_in (zero where
// kmap_t[k, n] is outside [0, n_g): the sentinel n_g), computes
//   d_feats[n]  = GG[n] @ WT          WT [K*Cout, Cin], WT[k*Cout+d][c] =
//                                     W_pair[k][c][d]   (skipped if dw_only)
//   dW_flat     = feats^T @ GG        [Cin, K*Cout] f32, summed over all rows.
// Operands are read in the activation type, products accumulate in f32;
// d_feats is stored in the activation type, dW_flat in f32. The caller
// unstacks dW_flat [Cin, K, Cout] -> dW_t [K, Cin, Cout] and un-mirrors
// same-level maps.
//
// Three bodies, chosen by dtype and shape (window_conv.im2col_tensor_cores
// is the same rule, K1's; a failed launch returns its error, there is no
// retry on another body):
//  * bf16 with Cout % 8 == 0, any Cin (every conv of the HRNet, Res16UNet,
//    ResUNet and ResNet families, the k5 stem included): the tensor-core
//    body, mma.sync m16n8k16 on bf16 operands with f32 accumulators;
//  * f32 with Cout % 8 == 0, any Cin: the same design in split TF32
//    (below), mma.sync m16n8k8 on TF32 operands, three products per f32
//    product (flash_tf32.cuh);
//  * Cout % 8 != 0, either type: the CUDA-core body, f32 FMAs.
//
// What bounds it on the H100: 4*Cin*Cout operations per valid (row,
// offset), the sum of K1 over the transpose map and sparse_conv_dw; what
// the form saves is the second gather of g. Every body runs the products
// over every row of a tile: the CUDA-core body at each chunk of K*Cout that
// holds a live offset, the tensor-core bodies at every chunk (below).
//
// The TPU grid is sequential and adds every tile's product into one
// resident dW block. Here the row tiles run in parallel, so each block
// (split s, tile of BC input channels) owns a contiguous run of row tiles
// and a private f32 partial part[s][c0 .. c0+BC][K*Cout]; a second kernel
// (common.cuh) sums the S partials in the order s = 0, 1, ... (no atomics,
// one fixed order: two runs give the same bits). The input channels are a
// grid dimension, so a wide conv gathers each GG chunk once per channel
// tile; both products split cleanly along it. dW [BC, K*Cout] does not fit
// on chip (1.7 MB at 64 x 6912), so a block writes it once per row tile and
// chunk: that traffic is what bounds a fused body.
//
// Tensor-core design (bf16). Block = (split, BC = 64 input channels, 16
// where Cin <= 16), 8 warps, one block per SM. It walks its steps: its
// super-tiles of SR = 256 rows in order, and in each the chunks of BJ = 64
// columns of K*Cout, as one pipeline of three stages:
//  1. A super-tile's feats tile [SR][BC + 8] comes in by cp.async (16-byte
//     pieces where Cin % 8 == 0, else element by element: the stem's rows
//     are 6 bytes) into one of two buffers, one step before its first
//     chunk.
//  2. Per step, warp w gathers GG's columns 8w .. 8w+7 of all SR rows, 16
//     bytes per (row, piece) by cp.async (Cout % 8 == 0, so a piece lies in
//     one offset and chunks may span offsets), zero-filled for a sentinel:
//     no read. The transpose-map entries are read into registers a step
//     before the gather that uses them; WT's [BJ][BC + 8] rows come by
//     cp.async beside it. The copies of the step after next are issued
//     right after the barrier that publishes this step's.
//  3. d_feats[SR x BC] += GG @ WT: warp w owns rows 32w .. 32w+31 (A by
//     ldmatrix, B by ldmatrix.trans, as in K1) and keeps them in registers
//     over the super-tile's chunks; they are stored once, in bf16.
//  4. dW[BC x BJ] = feats_tile^T @ GG: A = feats^T by ldmatrix.trans of
//     the feats tile (flash_tc.cuh load_a_t), B = GG by ldmatrix.trans; the
//     block's split stores it in its first super-tile and adds it in the
//     others, to its own slice (the values it adds to are read before the
//     step's products, so their latency hides behind them): R super-tiles
//     per split write dW R times where a 64-row walk wrote it 4R times, and
//     the partials need no zero fill. SR = 256 is what the d_feats
//     accumulators allow (64 f32 a lane). That write of dW, 8 bytes of
//     partial traffic per row and dW element, is what bounds this body:
//     the products over 256 rows are 2 x 256 operations per element.
// Every chunk runs, also one whose offsets have no live row in the
// super-tile: at 256 rows that is rare on the models' maps, and without a
// scan of the map for it the pipeline runs on across super-tiles. Such a
// chunk's gather is all zero-fill and its products add exact zeros, so a
// dead offset's dW is exactly zero. With dw_only (the stem) WT and d_feats are skipped.
// The stem's dW pads Cin 3 to BC = 16 (one m16 tile; 13 of 16 rows are
// zeros) rather than swapping the product's operands, and sums its 16
// k-steps in two halves so that its products do not wait on one another.
//
// Split-TF32 design (f32). The bf16 body's blocks, super-tiles of SR = 256
// rows, 8 warps, splits and partials (stored in the first super-tile,
// added after; no atomics, the same bits on every run), with f32 tiles:
//  * Chunks of BJ = 32 columns (128 bytes of a g row, as in bf16): warp w
//    gathers the 16-byte piece of columns 4w .. 4w+3 for all SR rows
//    (Cout % 8 == 0, so a piece lies in one offset).
//  * Shared memory: NST = 3 stages of GG [256][32 + 8] and WT [32][BC + 4]
//    words (48.5 KiB each at BC 64) and ONE feats tile [256][BC + 8] words
//    (72 KiB), 217.5 KiB in all of the 227 KiB a block can opt into: two
//    feats tiles do not fit beside three stages. The next super-tile's feats
//    therefore load after the last chunk's dW products, at the barrier of
//    its first chunk, while that chunk's d_feats products run; its dW
//    products wait for them (once per super-tile of K*Cout / 32 chunks).
//  * d_feats += GG @ WT in K1's split-TF32 fragment layout (A: rows g, g +
//    8 and columns 2t, 2t + 1 of GG, two 8-byte loads; B: rows 2t, 2t + 1
//    and column g of WT): the row strides, 40 and BC + 4 words, are 8 and 4
//    modulo 32, so the loads hit 32 distinct banks. Warp w keeps rows 32w
//    .. 32w+31 x BC channels (64 f32 a lane at BC 64) over the super-tile's
//    chunks and stores them once, in f32.
//  * dW = feats_tile^T @ GG: A is the feats tile read transposed and B is
//    GG read down its rows, both with scalar loads (no ldmatrix for 32-bit
//    elements). Their k (a row of the super-tile) runs in the order t, t +
//    4 of the fragments (A: channels g, g + 8 at rows t, t + 4; B: rows t, t
//    + 4 at column g), where the bank of a load is 8t + g at row strides of
//    BC + 8 and 40 words: 32 distinct banks for both. (K1's order, rows 2t,
//    2t + 1, would put GG's rows 2t at one bank pair: 2 x 40 = 16 mod 32.)
//    Warp (wm, wn) owns 16 channels x 16 columns of the chunk; at the stem
//    (BC 16) warps 0-3 own one 8-column block each and warps 4-7 only
//    gather.
//  * Every chunk runs over every row of the super-tile, as in bf16. Leaving
//    out the products that would add exact zeros (an m16 tile of d_feats
//    rows, or a k-step of 8 dW rows, without a live row at the offset, from
//    warp ballots of the gathered map entries) ran slower at HRNet's maps
//    (tools/im2col_bwd_designs.py): the products' count does not bound
//    this body.
//  * Each k-step's three products (lo.hi, hi.lo, hi.hi) go into a fresh
//    fragment that an f32 add puts into the running sum, in both products:
//    the tensor cores truncate the sum of every mma.sync, and one
//    accumulator over a long run misses the f32 checks' 1e-4 (as in K1's
//    split-TF32 body).
//    dW's sum over a super-tile's 32 k-steps goes into the partial once.
//  * The f32 rows are 16-byte pieces at Cin % 4 == 0 (feats, WT); the
//    stem's 12-byte feats rows are loaded element by element.
//
// CUDA-core design (Cout % 8 != 0). For each of its 64-row tiles the block
// stages the tile's transpose-map columns and its feats rows in shared memory,
// then walks K*Cout in chunks of 64 columns: it gathers GG[:, chunk] into
// shared memory once, adds GG[:, chunk] @ WT[chunk] to the d_feats tile it
// keeps in registers, forms feats_tile^T @ GG[:, chunk] in registers and
// adds it to its partial in device memory, zeroed by the caller (no other
// block touches that slice, so the read-modify-write needs no atomics). A
// chunk whose offsets have no valid row in the tile is skipped. S is bounded
// by the caller so that the partials stay within a fixed memory budget. BC
// is 16 for the 3-channel stem and 64 otherwise.

#include <type_traits>

#include "common.cuh"
#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace {

constexpr int BM = 64;   // rows per tile
constexpr int BJ = 64;   // columns of the flattened axis per chunk
constexpr int THREADS = 256;

template <typename T, int MI>
__global__ void __launch_bounds__(THREADS)
im2col_bwd_kernel(const T* __restrict__ feats, const T* __restrict__ g,
                  const int32_t* __restrict__ kmap_t,
                  const T* __restrict__ wt, T* __restrict__ dfeats,
                  float* __restrict__ part, int64_t n_in, int64_t n_g,
                  int n_off, int cin, int cout, int64_t n_tiles,
                  int64_t tiles_per_split, int dw_only) {
  constexpr int BC = 16 * MI;  // input channels per block
  extern __shared__ __align__(16) unsigned char smem[];
  float* Gs = reinterpret_cast<float*>(smem);        // [BM][BJ] GG chunk
  float* Ws = Gs + BM * BJ;                          // [BJ][BC] WT chunk
  float* Fs = Ws + BJ * BC;                          // [BM][BC] feats tile
  int32_t* ks = reinterpret_cast<int32_t*>(Fs + BM * BC);  // [n_off][BM]
  int32_t* live = ks + n_off * BM;                   // [n_off]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int s = blockIdx.x;
  const int c0 = blockIdx.y * BC;
  const int64_t kj = (int64_t)n_off * cout;  // length of the flattened axis
  float* my = part + (int64_t)s * cin * kj;
  const int64_t t_begin = (int64_t)s * tiles_per_split;
  const int64_t t_end =
      t_begin + tiles_per_split < n_tiles ? t_begin + tiles_per_split : n_tiles;
  const bool vec = (kj & 3) == 0;

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t m0 = t * BM;
    for (int k = tid; k < n_off; k += THREADS) live[k] = 0;
    __syncthreads();
    for (int e = tid; e < n_off * BM; e += THREADS) {
      const int k = e / BM, m = e % BM;
      const int64_t i = m0 + m;
      int32_t r = -1;
      if (i < n_in) {
        const int32_t v = kmap_t[(int64_t)k * n_in + i];
        if (v >= 0 && v < n_g) r = v;
      }
      ks[e] = r;
      if (r >= 0) live[k] = 1;  // every writer stores the same value
    }
    for (int e = tid; e < BM * BC; e += THREADS) {
      const int r = e / BC, c = e % BC;
      const int64_t i = m0 + r;
      Fs[e] = (i < n_in && c0 + c < cin)
                  ? csn::to_f32(feats[i * cin + c0 + c])
                  : 0.f;
    }
    __syncthreads();

    // d_feats tile: rows ty*4 .. +3, input channels c0 + tx*MI .. +MI-1
    float dacc[4][MI];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < MI; ++m) dacc[i][m] = 0.f;

    for (int64_t j0 = 0; j0 < kj; j0 += BJ) {
      {  // the same for every thread: live[] is read-only here
        const int k_lo = (int)(j0 / cout);
        const int64_t j_hi = j0 + BJ - 1 < kj - 1 ? j0 + BJ - 1 : kj - 1;
        const int k_hi = (int)(j_hi / cout);
        int any = 0;
        for (int k = k_lo; k <= k_hi; ++k) any |= live[k];
        if (!any) continue;
      }
      {  // column jj = tid % BJ of rows tid / BJ, + 4, ...: the (offset,
         // channel) of the column is the same for all of a thread's rows
        const int jj = tid % BJ;
        const int64_t j = j0 + jj;
        const int k = (int)(j / cout);
        const int d = (int)(j - (int64_t)k * cout);
        for (int r = tid / BJ; r < BM; r += THREADS / BJ) {
          float v = 0.f;
          if (j < kj) {
            const int32_t gi = ks[k * BM + r];
            if (gi >= 0) v = csn::to_f32(g[(int64_t)gi * cout + d]);
          }
          Gs[r * BJ + jj] = v;
        }
      }
      if (!dw_only) {
        for (int e = tid; e < BJ * BC; e += THREADS) {
          const int jj = e / BC, c = e % BC;
          const int64_t j = j0 + jj;
          Ws[e] = (j < kj && c0 + c < cin)
                      ? csn::to_f32(wt[j * cin + c0 + c])
                      : 0.f;
        }
      }
      __syncthreads();

      if (!dw_only) {
        // four columns at a time: each row's four GG values are one 16-byte
        // load (the two rows groups of a warp read the same address)
#pragma unroll 2
        for (int j4 = 0; j4 < BJ; j4 += 4) {
          float av[4][4], bv[4][MI];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(
                &Gs[(ty * 4 + i) * BJ + j4]);
            av[i][0] = a.x;
            av[i][1] = a.y;
            av[i][2] = a.z;
            av[i][3] = a.w;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int m = 0; m < MI; ++m)
              bv[q][m] = Ws[(j4 + q) * BC + tx * MI + m];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int m = 0; m < MI; ++m)
                dacc[i][m] = fmaf(av[i][q], bv[q][m], dacc[i][m]);
        }
      }

      // dW chunk: input channels c0 + ty*MI .. +MI-1, columns j0 + tx*4 .. +3
      float wacc[MI][4];
#pragma unroll
      for (int m = 0; m < MI; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) wacc[m][q] = 0.f;
#pragma unroll 8
      for (int r = 0; r < BM; ++r) {
        float av[MI];
#pragma unroll
        for (int m = 0; m < MI; ++m) av[m] = Fs[r * BC + ty * MI + m];
        const float4 b = *reinterpret_cast<const float4*>(&Gs[r * BJ + tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int m = 0; m < MI; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wacc[m][q] = fmaf(av[m], bv[q], wacc[m][q]);
      }
#pragma unroll
      for (int m = 0; m < MI; ++m) {
        const int c = c0 + ty * MI + m;
        if (c >= cin) continue;
        float* p = my + (int64_t)c * kj + j0 + tx * 4;
        if (vec && j0 + tx * 4 + 3 < kj) {
          float4 old = *reinterpret_cast<float4*>(p);
          old.x += wacc[m][0];
          old.y += wacc[m][1];
          old.z += wacc[m][2];
          old.w += wacc[m][3];
          *reinterpret_cast<float4*>(p) = old;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (j0 + tx * 4 + q < kj) p[q] += wacc[m][q];
        }
      }
      __syncthreads();  // Gs and Ws are rewritten by the next chunk
    }

    if (!dw_only) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t row = m0 + ty * 4 + i;
        if (row >= n_in) continue;
#pragma unroll
        for (int m = 0; m < MI; ++m) {
          const int c = c0 + tx * MI + m;
          if (c < cin) csn::store(dacc[i][m], dfeats + row * cin + c);
        }
      }
    }
    __syncthreads();  // ks, live and Fs are rewritten by the next tile
  }
}

template <int MI>
size_t smem_bytes(int n_off) {
  constexpr int BC = 16 * MI;
  return (size_t)(BM * BJ + BJ * BC + BM * BC) * sizeof(float) +
         (size_t)n_off * (BM + 1) * sizeof(int32_t);
}

template <typename T, int MI>
cudaError_t launch(const void* feats, const void* g, const void* kmap_t,
                   const void* wt, void* dfeats, void* part, void* out,
                   int64_t n_in, int64_t n_g, int n_off, int cin, int cout,
                   int n_split, int dw_only, cudaStream_t stream) {
  constexpr int BC = 16 * MI;
  const size_t bytes = smem_bytes<MI>(n_off);
  cudaError_t err = cudaFuncSetAttribute(
      im2col_bwd_kernel<T, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = (n_in + BM - 1) / BM;
  const int64_t tiles_per_split = (n_tiles + n_split - 1) / n_split;
  const dim3 grid((unsigned)n_split, (unsigned)((cin + BC - 1) / BC));
  // one split accumulates straight into the (zeroed) result
  float* dst = static_cast<float*>(n_split == 1 ? out : part);
  im2col_bwd_kernel<T, MI><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(g),
      static_cast<const int32_t*>(kmap_t), static_cast<const T*>(wt),
      static_cast<T*>(dfeats), dst, n_in, n_g, n_off, cin, cout, n_tiles,
      tiles_per_split, dw_only);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int64_t n = (int64_t)cin * n_off * cout;
  csn::sum_splits_kernel<THREADS>
      <<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          static_cast<const float*>(part), static_cast<float*>(out), n,
          n_split);
  return cudaGetLastError();
}

// --- the tensor-core body (bf16, Cout % 8 == 0) ----------------------------

using csn_tc::bf16;
using csn_tc::cp_async16;
using csn_tc::cp_async_commit;
using csn_tc::cp_async_wait;
using csn_tc::ldsm_x4;
using csn_tc::ldsm_x4_t;
using csn_tc::mma;
using csn_tc::pack;

constexpr int SR = 256;        // rows per super-tile
constexpr int LDG = BJ + 8;    // GG tile row stride (flash_tc.cuh's LDS)
constexpr int NWARPS = THREADS / 32;
constexpr int RPL = SR / 32;   // GG rows a lane gathers per chunk
constexpr int NST = 3;         // stages of the chunk pipeline
static_assert(BJ == 8 * NWARPS, "a warp gathers one 8-column piece");
static_assert(SR == 32 * NWARPS, "a warp owns 32 rows of d_feats");

template <int MC>
struct BwdTile {
  static constexpr int BC = 16 * MC;     // input channels per block
  static constexpr int LDF = BC + 8;     // feats and WT tile row stride
  static constexpr int G_ELEMS = SR * LDG;
  static constexpr int STAGE_ELEMS = G_ELEMS + BJ * LDF;
  static constexpr int F_ELEMS = SR * LDF;
  // NST stages (GG, WT), two feats tiles (this super-tile's, the next's)
  static constexpr size_t SMEM =
      sizeof(bf16) * (NST * STAGE_ELEMS + 2 * F_ELEMS);
};

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(csn_tc::smem_addr(p)));
}

// flash_tc.cuh load_a_t for a tile whose rows are LD elements apart: the A
// fragment of k-step ks of T^T for T's columns col0 .. col0+15
template <int LD>
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* tile,
                                         int col0, int ks, int lane) {
  ldsm_x4_t(a, tile + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * LD + col0 +
                   ((lane >> 3) & 1) * 8);
}

template <int MC>
__global__ void __launch_bounds__(THREADS, 1)
im2col_bwd_tc_kernel(const bf16* __restrict__ feats,
                     const bf16* __restrict__ g,
                     const int32_t* __restrict__ kmap_t,
                     const bf16* __restrict__ wt, bf16* __restrict__ dfeats,
                     float* __restrict__ part, int64_t n_in, int64_t n_g,
                     int n_off, int cin, int cout, int64_t n_st,
                     int64_t st_per_split, int dw_only) {
  using Tl = BwdTile<MC>;
  constexpr int BC = Tl::BC, LDF = Tl::LDF;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
  bf16* ftiles = stages + NST * Tl::STAGE_ELEMS;  // [2][SR][LDF]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.y * BC;
  const int kj = n_off * cout;  // length of the flattened axis
  const int n_chunks = (kj + BJ - 1) / BJ;
  float* my = part + (int64_t)blockIdx.x * cin * kj;
  const bool vec = cin % 8 == 0;  // feats and WT rows in 16-byte pieces
  const int64_t t_begin = (int64_t)blockIdx.x * st_per_split;
  const int64_t t_end =
      t_begin + st_per_split < n_st ? t_begin + st_per_split : n_st;
  // dW: warp (wm, wn) owns input channels c0 + 16 wm .. +15 and columns
  // colw .. colw + 8 MC - 1 of a chunk
  const int wm = warp % MC, wn = warp / MC;
  const int colw = 8 * MC * wn;

  if (t_begin >= t_end) {  // a split without rows: its dW is zero
    for (int e = tid; e < BC * kj; e += THREADS) {
      const int c = c0 + e / kj;
      if (c < cin) my[(int64_t)c * kj + e % kj] = 0.f;
    }
    return;
  }
  // the steps, (super-tile, chunk) in that order
  struct Step {
    int64_t t;
    int c;
  };
  auto advance = [&](Step& p) {
    if (++p.c == n_chunks) p.c = 0, ++p.t;
  };

  // 1. the feats tile of super-tile t into its buffer (t & 1)
  auto load_feats = [&](int64_t t) {
    const int64_t m0 = t * SR;
    bf16* fs = ftiles + (t & 1) * Tl::F_ELEMS;
    if (vec) {
      for (int e = tid; e < SR * (BC / 8); e += THREADS) {
        const int r = e / (BC / 8), q = (e % (BC / 8)) * 8;
        const bool ok = m0 + r < n_in && c0 + q < cin;
        cp_async16(fs + r * LDF + q,
                   feats + (ok ? (m0 + r) * cin + c0 + q : 0), ok);
      }
    } else {
      for (int e = tid; e < SR * BC; e += THREADS) {
        const int r = e / BC, q = e % BC;
        fs[r * LDF + q] = m0 + r < n_in && c0 + q < cin
                              ? feats[(m0 + r) * cin + c0 + q]
                              : __float2bfloat16(0.f);
      }
    }
  };
  // the transpose-map entries of this lane's piece of step p: column
  // c*BJ + 8 warp, rows m0 + lane + 32 q (-1 past the end)
  int32_t mv[RPL];
  auto load_map = [&](const Step& p) {
    if (p.t >= t_end) return;
    const int64_t m0 = p.t * SR;
    const int j = p.c * BJ + 8 * warp;
    const bool ok = j < kj;
    const int32_t* km = kmap_t + (int64_t)(ok ? j / cout : 0) * n_in + m0;
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int r = lane + 32 * q;
      mv[q] = ok && m0 + r < n_in ? __ldg(km + r) : -1;
    }
  };
  // 2. the copies of step p into stage st: GG [SR][BJ] and WT [BJ][BC]
  auto issue = [&](int st, const Step& p) {
    bf16* gs = stages + st * Tl::STAGE_ELEMS;
    bf16* ws = gs + Tl::G_ELEMS;
    const int jb = p.c * BJ;
    const int j = jb + 8 * warp;
    const int d = j < kj ? j % cout : 0;
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int32_t v = mv[q];
      const bool ok = v >= 0 && v < n_g;
      cp_async16(gs + (lane + 32 * q) * LDG + 8 * warp,
                 g + (ok ? (int64_t)v * cout + d : 0), ok);
    }
    if (dw_only) return;
    if (vec) {
      for (int e = tid; e < BJ * (BC / 8); e += THREADS) {
        const int r = e / (BC / 8), q = (e % (BC / 8)) * 8;
        const bool ok = jb + r < kj && c0 + q < cin;
        cp_async16(ws + r * LDF + q,
                   wt + (ok ? (int64_t)(jb + r) * cin + c0 + q : 0), ok);
      }
    } else {
      for (int e = tid; e < BJ * BC; e += THREADS) {
        const int r = e / BC, q = e % BC;
        ws[r * LDF + q] = jb + r < kj && c0 + q < cin
                              ? wt[(int64_t)(jb + r) * cin + c0 + q]
                              : __float2bfloat16(0.f);
      }
    }
  };

  float dacc[2][2 * MC][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 2 * MC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[i][n][e] = 0.f;

  // The steps run as one pipeline of NST stages over all super-tiles of
  // the split, with one barrier each, which publishes the step's tiles and
  // orders every warp's reads of the stage (and feats buffer) that the
  // copies issued after it overwrite. A step's copies are issued two steps
  // ahead, the next super-tile's feats tile one step ahead in a group of
  // its own, so that the wait for all but the newest group covers both.
  load_feats(t_begin);
  cp_async_commit();
  Step ahead{t_begin, 0};  // the step whose copies go out next
  load_map(ahead);
  issue(0, ahead);
  cp_async_commit();
  advance(ahead);
  load_map(ahead);
  if (ahead.t < t_end) issue(1, ahead);
  cp_async_commit();
  advance(ahead);
  load_map(ahead);
  int64_t t = t_begin;  // this step's super-tile and chunk
  int c = 0;
  for (int st = 0; t < t_end; st = st == NST - 1 ? 0 : st + 1) {
    cp_async_wait<1>();
    __syncthreads();
    if (c == n_chunks - 1 && t + 1 < t_end) {
      load_feats(t + 1);
      cp_async_commit();
    }
    if (ahead.t < t_end) issue((st + 2) % NST, ahead);
    cp_async_commit();
    advance(ahead);
    load_map(ahead);
    const bool first = t == t_begin;
    const int64_t m0 = t * SR;
    const bf16* gs = stages + st * Tl::STAGE_ELEMS;
    const bf16* ws = gs + Tl::G_ELEMS;
    const bf16* fs = ftiles + (t & 1) * Tl::F_ELEMS;
    // this chunk's dW so far (later super-tiles add to it): loaded now,
    // added after the products
    float2 old[MC][2];
    if (!first && c0 + 16 * wm < cin) {
#pragma unroll
      for (int n = 0; n < MC; ++n) {
        const int col = c * BJ + colw + 8 * n + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ch = c0 + 16 * wm + gq + 8 * h;
          old[n][h] = col < kj && ch < cin
                          ? *reinterpret_cast<const float2*>(
                                my + (int64_t)ch * kj + col)
                          : make_float2(0.f, 0.f);
        }
      }
    }
    if (!dw_only) {  // 3. d_feats += GG @ WT
#pragma unroll
      for (int ks = 0; ks < BJ / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          ldsm_x4(a[q], gs + (32 * warp + 16 * q + (lane & 15)) * LDG +
                            ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nb2 = 0; nb2 < MC; ++nb2) {
          uint32_t b[4];
          ldsm_x4_t(b, ws + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LDF +
                           nb2 * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            mma(dacc[q][2 * nb2], a[q], b[0], b[1]);
            mma(dacc[q][2 * nb2 + 1], a[q], b[2], b[3]);
          }
        }
      }
    }
    if (c0 + 16 * wm < cin) {  // 4. dW = feats_tile^T @ GG
      // two sums over alternate k-steps where a warp has one column block,
      // so that its products do not wait on one another
      constexpr int NS = MC == 1 ? 2 : 1;
      float wacc[NS][MC][4];
#pragma unroll
      for (int p = 0; p < NS; ++p)
#pragma unroll
        for (int n = 0; n < MC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) wacc[p][n][e] = 0.f;
#pragma unroll 4
      for (int ks = 0; ks < SR / 16; ++ks) {
        uint32_t a[4];
        load_a_t<LDF>(a, fs, 16 * wm, ks, lane);
        const bf16* brow =
            gs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDG + colw;
        if constexpr (MC == 1) {
          uint32_t b[2];
          ldsm_x2_t(b, brow);
          mma(wacc[ks & 1][0], a, b[0], b[1]);
        } else {
#pragma unroll
          for (int nb2 = 0; nb2 < MC / 2; ++nb2) {
            uint32_t b[4];
            ldsm_x4_t(b, brow + nb2 * 16 + (lane >> 4) * 8);
            mma(wacc[0][2 * nb2], a, b[0], b[1]);
            mma(wacc[0][2 * nb2 + 1], a, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < MC; ++n) {
        const int col = c * BJ + colw + 8 * n + 2 * t4;
        if (col >= kj) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ch = c0 + 16 * wm + gq + 8 * h;
          if (ch >= cin) continue;
          float2 v = make_float2(wacc[0][n][2 * h], wacc[0][n][2 * h + 1]);
          if constexpr (NS == 2) {
            v.x += wacc[1][n][2 * h];
            v.y += wacc[1][n][2 * h + 1];
          }
          if (!first) {
            v.x += old[n][h].x;
            v.y += old[n][h].y;
          }
          *reinterpret_cast<float2*>(my + (int64_t)ch * kj + col) = v;
        }
      }
    }
    if (c == n_chunks - 1) {  // the super-tile's d_feats, stored once
      if (!dw_only) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t row = m0 + 32 * warp + 16 * q + gq + 8 * h;
            if (row >= n_in) continue;
            bf16* dst = dfeats + row * cin;
#pragma unroll
            for (int n = 0; n < 2 * MC; ++n) {
              const int ch = c0 + 8 * n + 2 * t4;
              const float lo = dacc[q][n][2 * h], hi = dacc[q][n][2 * h + 1];
              if (ch + 1 < cin && cin % 2 == 0) {
                *reinterpret_cast<uint32_t*>(dst + ch) = pack(lo, hi);
              } else {
                if (ch < cin) dst[ch] = __float2bfloat16(lo);
                if (ch + 1 < cin) dst[ch + 1] = __float2bfloat16(hi);
              }
            }
          }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int n = 0; n < 2 * MC; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dacc[q][n][e] = 0.f;
      }
      ++t, c = 0;
    } else {
      ++c;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// the tensor-core body's channel tile at this Cin: 16 (MC 1) for the stem,
// else 64 (MC 4)
bool tc_narrow(int cin) { return cin <= 16; }

// --- the split-TF32 body (f32, Cout % 8 == 0) -------------------------------

using csn_tf32::FragA;
using csn_tf32::FragB;
using csn_tf32::mma_tf32;
using csn_tf32::split;

constexpr int TBJ = 32;          // columns per chunk: 128 bytes of a g row
constexpr int LDT = TBJ + 8;     // GG tile row stride, words
static_assert(TBJ == 4 * NWARPS, "a warp gathers one 4-column piece");

template <int MC>
struct Tf32Tile {
  static constexpr int BC = 16 * MC;   // input channels per block
  static constexpr int LDW = BC + 4;   // WT tile row stride, words
  static constexpr int LDF = BC + 8;   // feats tile row stride, words
  static constexpr int G_ELEMS = SR * LDT;
  static constexpr int STAGE_ELEMS = G_ELEMS + TBJ * LDW;
  static constexpr int F_ELEMS = SR * LDF;
  // NST stages (GG, WT), one feats tile
  static constexpr size_t SMEM =
      sizeof(float) * (NST * STAGE_ELEMS + F_ELEMS);
};

template <int MC>
__global__ void __launch_bounds__(THREADS, 1)
im2col_bwd_tf32_kernel(const float* __restrict__ feats,
                       const float* __restrict__ g,
                       const int32_t* __restrict__ kmap_t,
                       const float* __restrict__ wt,
                       float* __restrict__ dfeats, float* __restrict__ part,
                       int64_t n_in, int64_t n_g, int n_off, int cin, int cout,
                       int64_t n_st, int64_t st_per_split, int dw_only) {
  using Tl = Tf32Tile<MC>;
  constexpr int BC = Tl::BC, LDW = Tl::LDW, LDF = Tl::LDF;
  constexpr int NB = 2 * MC;              // d_feats: n8 blocks of a warp
  constexpr int DW_NB = MC == 1 ? 1 : 2;  // dW: n8 blocks of a warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);
  float* fs = stages + NST * Tl::STAGE_ELEMS;  // [SR][LDF]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.y * BC;
  const int kj = n_off * cout;  // length of the flattened axis
  const int n_chunks = (kj + TBJ - 1) / TBJ;
  float* my = part + (int64_t)blockIdx.x * cin * kj;
  const bool vec = cin % 4 == 0;  // feats and WT rows in 16-byte pieces
  const int64_t t_begin = (int64_t)blockIdx.x * st_per_split;
  const int64_t t_end =
      t_begin + st_per_split < n_st ? t_begin + st_per_split : n_st;
  // dW: warp (wm, wn) owns input channels c0 + 16 wm .. +15 and columns
  // colw .. colw + 8 DW_NB - 1 of a chunk (MC 1: warps 0-3, one n8 block
  // each; warps 4-7 only gather)
  const int wm = MC == 1 ? 0 : warp % 4;
  const int colw = MC == 1 ? 8 * warp : 16 * (warp / 4);
  const bool dw_warp = colw < TBJ && c0 + 16 * wm < cin;

  if (t_begin >= t_end) {  // a split without rows: its dW is zero
    for (int e = tid; e < BC * kj; e += THREADS) {
      const int c = c0 + e / kj;
      if (c < cin) my[(int64_t)c * kj + e % kj] = 0.f;
    }
    return;
  }
  struct Step {
    int64_t t;
    int c;
  };
  auto advance = [&](Step& p) {
    if (++p.c == n_chunks) p.c = 0, ++p.t;
  };
  // the feats tile of super-tile t (rows past n_in, channels past Cin zero)
  auto load_feats = [&](int64_t t) {
    const int64_t m0 = t * SR;
    if (vec) {
      for (int e = tid; e < SR * (BC / 4); e += THREADS) {
        const int r = e / (BC / 4), q = (e % (BC / 4)) * 4;
        const bool ok = m0 + r < n_in && c0 + q < cin;
        cp_async16(fs + r * LDF + q,
                   feats + (ok ? (m0 + r) * cin + c0 + q : 0), ok);
      }
    } else {
      for (int e = tid; e < SR * BC; e += THREADS) {
        const int r = e / BC, q = e % BC;
        fs[r * LDF + q] = m0 + r < n_in && c0 + q < cin
                              ? feats[(m0 + r) * cin + c0 + q]
                              : 0.f;
      }
    }
  };
  // the transpose-map entries of this lane's piece of step p: column
  // c*TBJ + 4 warp, rows m0 + lane + 32 q (-1 past the end)
  int32_t mv[RPL];
  auto load_map = [&](const Step& p) {
    if (p.t >= t_end) return;
    const int64_t m0 = p.t * SR;
    const int j = p.c * TBJ + 4 * warp;
    const bool ok = j < kj;
    const int32_t* km = kmap_t + (int64_t)(ok ? j / cout : 0) * n_in + m0;
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int r = lane + 32 * q;
      mv[q] = ok && m0 + r < n_in ? __ldg(km + r) : -1;
    }
  };
  // the copies of step p into stage st: GG [SR][TBJ] and WT [TBJ][BC]
  auto issue = [&](int st, const Step& p) {
    float* gs = stages + st * Tl::STAGE_ELEMS;
    float* ws = gs + Tl::G_ELEMS;
    const int jb = p.c * TBJ;
    const int j = jb + 4 * warp;
    const int d = j < kj ? j % cout : 0;
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int32_t v = mv[q];
      const bool ok = v >= 0 && v < n_g;
      cp_async16(gs + (lane + 32 * q) * LDT + 4 * warp,
                 g + (ok ? (int64_t)v * cout + d : 0), ok);
    }
    if (dw_only) return;
    if (vec) {
      for (int e = tid; e < TBJ * (BC / 4); e += THREADS) {
        const int r = e / (BC / 4), q = (e % (BC / 4)) * 4;
        const bool ok = jb + r < kj && c0 + q < cin;
        cp_async16(ws + r * LDW + q,
                   wt + (ok ? (int64_t)(jb + r) * cin + c0 + q : 0), ok);
      }
    } else {
      for (int e = tid; e < TBJ * BC; e += THREADS) {
        const int r = e / BC, q = e % BC;
        ws[r * LDW + q] = jb + r < kj && c0 + q < cin
                              ? wt[(int64_t)(jb + r) * cin + c0 + q]
                              : 0.f;
      }
    }
  };

  float dacc[2][NB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[i][n][e] = 0.f;

  // One pipeline of NST stages over all super-tiles of the split, as the
  // bf16 body's, with one barrier per step. The one feats tile is
  // refilled at the first chunk of each later super-tile, right after the
  // barrier that ends the last chunk's reads of it, in a group of its own
  // ahead of the step's stage copies; the d_feats products run while it
  // lands, the dW products after a wait and a second barrier.
  load_feats(t_begin);
  cp_async_commit();
  Step ahead{t_begin, 0};  // the step whose copies go out next
  load_map(ahead);
  issue(0, ahead);
  cp_async_commit();
  advance(ahead);
  load_map(ahead);
  if (ahead.t < t_end) issue(1, ahead);
  cp_async_commit();
  advance(ahead);
  load_map(ahead);
  int64_t t = t_begin;  // this step's super-tile and chunk
  int c = 0;
  for (int st = 0; t < t_end; st = st == NST - 1 ? 0 : st + 1) {
    cp_async_wait<1>();
    __syncthreads();
    const bool refill = c == 0 && t != t_begin;
    if (refill) {
      load_feats(t);
      cp_async_commit();
    }
    if (ahead.t < t_end) issue((st + 2) % NST, ahead);
    cp_async_commit();
    advance(ahead);
    load_map(ahead);
    const bool first = t == t_begin;
    const int64_t m0 = t * SR;
    const float* gs = stages + st * Tl::STAGE_ELEMS;
    const float* ws = gs + Tl::G_ELEMS;
    // this chunk's dW so far (later super-tiles add to it): loaded now,
    // added after the products
    float2 old[DW_NB][2];
    if (!first && dw_warp) {
#pragma unroll
      for (int n = 0; n < DW_NB; ++n) {
        const int col = c * TBJ + colw + 8 * n + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ch = c0 + 16 * wm + gq + 8 * h;
          old[n][h] = col < kj && ch < cin
                          ? *reinterpret_cast<const float2*>(
                                my + (int64_t)ch * kj + col)
                          : make_float2(0.f, 0.f);
        }
      }
    }
    if (!dw_only) {
      // d_feats += GG @ WT over the chunk's k-steps of 8 columns (none past
      // K*Cout): warp w's rows 32w .. 32w+31, K1's fragment layout
      // (sparse_conv_tc.cuh tf32_kstep: A at rows g, g + 8 and columns 2t,
      // 2t + 1; B at rows 2t, 2t + 1 and column g), the step's three
      // products into a fresh fragment added in f32
      const int nks = min(TBJ, kj - c * TBJ) / 8;
#pragma unroll
      for (int ks = 0; ks < TBJ / 8; ++ks) {
        if (ks >= nks) break;
        FragA a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* p = gs + (32 * warp + 16 * i + gq) * LDT + ks * 8 +
                           2 * t4;
          csn_tf32::split_a(a[i], csn_tf32::ld2(p),
                            csn_tf32::ld2(p + 8 * LDT));
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (c0 + 8 * nb >= cin) break;
          const float* q = ws + (ks * 8 + 2 * t4) * LDW + 8 * nb + gq;
          FragB b;
          split(q[0], b.hi[0], b.lo[0]);
          split(q[LDW], b.hi[1], b.lo[1]);
          float p[2][4] = {};
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_tf32(p[i], a[i].lo, b.hi);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_tf32(p[i], a[i].hi, b.lo);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_tf32(p[i], a[i].hi, b.hi);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) dacc[i][nb][e] += p[i][e];
        }
      }
    }
    if (refill) {  // the super-tile's feats tile has landed
      cp_async_wait<1>();
      __syncthreads();
    }
    if (dw_warp) {
      // dW = feats_tile^T @ GG over the super-tile's k-steps of 8 rows, in
      // the k order t, t + 4 (A: channels g, g + 8 at rows t, t + 4 of the
      // feats tile; B: rows t, t + 4 and column g of GG), scalar loads on
      // 32 distinct banks at these strides; each k-step's three products
      // into a fresh fragment added in f32
      float wacc[DW_NB][4];
#pragma unroll
      for (int n = 0; n < DW_NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) wacc[n][e] = 0.f;
#pragma unroll 8
      for (int ks = 0; ks < SR / 8; ++ks) {
        const float* fa = fs + (ks * 8 + t4) * LDF + 16 * wm + gq;
        FragA a;
        split(fa[0], a.hi[0], a.lo[0]);
        split(fa[8], a.hi[1], a.lo[1]);
        split(fa[4 * LDF], a.hi[2], a.lo[2]);
        split(fa[4 * LDF + 8], a.hi[3], a.lo[3]);
        const float* gb = gs + (ks * 8 + t4) * LDT + colw + gq;
#pragma unroll
        for (int n = 0; n < DW_NB; ++n) {
          FragB b;
          split(gb[8 * n], b.hi[0], b.lo[0]);
          split(gb[4 * LDT + 8 * n], b.hi[1], b.lo[1]);
          float p[4] = {};
          mma_tf32(p, a.lo, b.hi);
          mma_tf32(p, a.hi, b.lo);
          mma_tf32(p, a.hi, b.hi);
#pragma unroll
          for (int e = 0; e < 4; ++e) wacc[n][e] += p[e];
        }
      }
#pragma unroll
      for (int n = 0; n < DW_NB; ++n) {
        const int col = c * TBJ + colw + 8 * n + 2 * t4;
        if (col >= kj) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ch = c0 + 16 * wm + gq + 8 * h;
          if (ch >= cin) continue;
          float2 v = make_float2(wacc[n][2 * h], wacc[n][2 * h + 1]);
          if (!first) {
            v.x += old[n][h].x;
            v.y += old[n][h].y;
          }
          *reinterpret_cast<float2*>(my + (int64_t)ch * kj + col) = v;
        }
      }
    }
    if (c == n_chunks - 1) {  // the super-tile's d_feats, stored once
      if (!dw_only) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t row = m0 + 32 * warp + 16 * i + gq + 8 * h;
            if (row >= n_in) continue;
            float* dst = dfeats + row * cin;
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              const int ch = c0 + 8 * n + 2 * t4;
              const float lo = dacc[i][n][2 * h], hi = dacc[i][n][2 * h + 1];
              if (ch + 1 < cin && cin % 2 == 0) {
                *reinterpret_cast<float2*>(dst + ch) = make_float2(lo, hi);
              } else {
                if (ch < cin) dst[ch] = lo;
                if (ch + 1 < cin) dst[ch + 1] = hi;
              }
            }
          }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < NB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dacc[i][n][e] = 0.f;
      }
      ++t, c = 0;
    } else {
      ++c;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// the tensor-core body of an element type: bf16, or f32 in split TF32
template <int MC>
auto tc_kernel(const bf16*) {
  return im2col_bwd_tc_kernel<MC>;
}
template <int MC>
auto tc_kernel(const float*) {
  return im2col_bwd_tf32_kernel<MC>;
}

// the tensor-core bodies' launch, the same grid and splits in both types
template <typename T, int MC>
cudaError_t launch_tc(const void* feats, const void* g, const void* kmap_t,
                      const void* wt, void* dfeats, void* part, void* out,
                      int64_t n_in, int64_t n_g, int n_off, int cin, int cout,
                      int n_split, int dw_only, cudaStream_t stream) {
  constexpr int BC = 16 * MC;
  const size_t bytes = std::is_same<T, float>::value ? Tf32Tile<MC>::SMEM
                                                      : BwdTile<MC>::SMEM;
  const auto kernel = tc_kernel<MC>(static_cast<const T*>(nullptr));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int64_t n_st = (n_in + SR - 1) / SR;
  const int64_t st_per_split = (n_st + n_split - 1) / n_split;
  const dim3 grid((unsigned)n_split, (unsigned)((cin + BC - 1) / BC));
  // one split writes the result directly
  float* dst = static_cast<float*>(n_split == 1 ? out : part);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(g),
      static_cast<const int32_t*>(kmap_t), static_cast<const T*>(wt),
      static_cast<T*>(dfeats), dst, n_in, n_g, n_off, cin, cout, n_st,
      st_per_split, dw_only);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int64_t n = (int64_t)cin * n_off * cout;
  csn::sum_splits_kernel<THREADS>
      <<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          static_cast<const float*>(part), static_cast<float*>(out), n,
          n_split);
  return cudaGetLastError();
}

}  // namespace

// feats [n_in, cin], g [n_g, cout] and wt [n_off * cout, cin] of one type,
// kmap_t [n_off, n_in] int32 (sentinel n_g); dfeats [n_in, cin] of that type
// (unused with dw_only); part [n_split, cin, n_off * cout] f32 scratch
// (unused when n_split == 1), out [cin, n_off * cout] f32. The CUDA-core
// body adds into part (or out when n_split == 1), which the caller zeroes;
// the tensor-core body stores every element first. The tensor-core body
// copies g, and feats and wt where Cin % 8 == 0, 16 bytes at a time: those
// start on a 16-byte boundary.
extern "C" int csn_sparse_conv_im2col_bwd(int dtype, const void* feats,
                                          const void* g, const void* kmap_t,
                                          const void* wt, void* dfeats,
                                          void* part, void* out, int64_t n_in,
                                          int64_t n_g, int n_off, int cin,
                                          int cout, int n_split, int dw_only,
                                          void* stream) {
  if (n_off == 0 || cin == 0 || cout == 0) return cudaSuccess;
  if (n_split < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // with no rows the tensor-core bodies' blocks store dW's zeros
#define CSN_TC(T, MC)                                                     \
  return launch_tc<T, MC>(feats, g, kmap_t, wt, dfeats, part, out, n_in, \
                          n_g, n_off, cin, cout, n_split, dw_only, s)
  if (dtype == csn::kBF16 && cout % 8 == 0) {
    if (tc_narrow(cin)) CSN_TC(bf16, 1);
    CSN_TC(bf16, 4);
  }
  if (dtype == csn::kF32 && cout % 8 == 0) {
    if (tc_narrow(cin)) CSN_TC(float, 1);
    CSN_TC(float, 4);
  }
#undef CSN_TC
  if (n_in == 0) return cudaSuccess;
  const bool narrow = cin <= 16;
  if (dtype == csn::kF32)
    return narrow ? launch<float, 1>(feats, g, kmap_t, wt, dfeats, part, out,
                                     n_in, n_g, n_off, cin, cout, n_split,
                                     dw_only, s)
                  : launch<float, 4>(feats, g, kmap_t, wt, dfeats, part, out,
                                     n_in, n_g, n_off, cin, cout, n_split,
                                     dw_only, s);
  if (dtype == csn::kBF16)
    return narrow ? launch<__nv_bfloat16, 1>(feats, g, kmap_t, wt, dfeats,
                                             part, out, n_in, n_g, n_off, cin,
                                             cout, n_split, dw_only, s)
                  : launch<__nv_bfloat16, 4>(feats, g, kmap_t, wt, dfeats,
                                             part, out, n_in, n_g, n_off, cin,
                                             cout, n_split, dw_only, s);
  return cudaErrorInvalidValue;
}

// The tensor-core bodies' tiles, from which the wrapper sizes its splits
// (window_conv.im2col_bwd_tc_splits): rows per super-tile, and input
// channels per block at this Cin; the same in bf16 and in split TF32.
extern "C" int csn_sparse_conv_im2col_bwd_tc_rows() { return SR; }

extern "C" int csn_sparse_conv_im2col_bwd_tc_channels(int cin) {
  return tc_narrow(cin) ? BwdTile<1>::BC : BwdTile<4>::BC;
}
static_assert(BwdTile<1>::BC == Tf32Tile<1>::BC &&
                  BwdTile<4>::BC == Tf32Tile<4>::BC,
              "one channel tile in both types");
