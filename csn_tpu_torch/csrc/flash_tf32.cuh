// Split-TF32 building blocks of the f32 attention kernels on the tensor
// cores: the backward at head dims 256 and 128 (flash_tf32_bwd.cuh), the
// forwards at 256 (flash_tf32_fwd.cuh), 128 (flash_tf32_d128_fwd.cuh) and
// 64 (flash_tf32_d64_fwd.cuh).
//
// Split TF32. A TF32 operand keeps 10 stored mantissa bits, too few for the
// f32 checks' 1e-4 over a 256-long sum. Each f32 operand x is split, in
// registers, as its fragment is loaded: hi = tf32(x) (cvt.rn: round to
// nearest, ties to even) and lo = x - hi, exact in f32, of which
// the product reads the top 10 mantissa bits. Then
//   a . b ~= a_lo . b_hi + a_hi . b_lo + a_hi . b_hi,
// three m16n8k8 TF32 products into one f32 accumulator, the small ones
// first; the dropped a_lo . b_lo and lo's truncation are ~2^-22 of the
// product. (Rounding lo with a second cvt.rn would change nothing visible
// and cost one more conversion per operand.)
//
// Fragments (PTX ISA, "mma.m16n8k8" .tf32), lane = 4 g + t. The k order of
// one k-step is free as long as A and B agree, so logical k = t is
// physical column 2t and k = t + 4 column 2t + 1 of the step's 8 columns:
//  * A (16 x 8, row): a0 = (g, 2t), a1 = (g+8, 2t), a2 = (g, 2t+1),
//    a3 = (g+8, 2t+1): two 8-byte loads from a row-major tile;
//  * B (8 x 8, col): b0 = (k 2t, n g), b1 = (k 2t+1, n g): one 8-byte load
//    when B's columns are rows of the tile (K for S = Q K^T), two 4-byte
//    loads when B's rows are (dO, Q, K as the right factor of dV, dK, dQ
//    in the backward; V of the forward's P V);
//  * C (16 x 8, f32): c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
//
// Tiles. Q, dO, K and V tiles are [rows][D] f32, copied by cp.async (rows
// past L zero-filled), with the columns of row r XOR-swizzled by
// ((r ^ r >> 1) & 3) << 3 (bits 3-4, so 16-byte groups stay whole). Both
// access patterns then hit 32 distinct banks: rows g, columns 2t (the A and
// K-as-B fragments, 8-byte loads in half-warps) and rows 2t (+1), columns g
// (B fragments whose rows are the tile's rows: dO, Q, K or V).

#pragma once

#include "common.cuh"
#include "flash_tc.cuh"

namespace csn_tf32 {

using csn_tc::cp_async16;
using csn_tc::cp_async_commit;
using csn_tc::cp_async_wait;
using csn_tc::exp2_approx;
using csn_tc::find_live;
using csn_tc::LOG2E;
using csn_tc::row_live;
using Drop = csn::Drop;

// --- split-TF32 building blocks ---------------------------------------------

// x rounded to TF32 (round to nearest, ties to even), as f32 bits: one
// instruction on sm_90 (cvt.rna, ties away from zero, takes several, and
// both split-TF32 bodies ran slower with it)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo exactly, hi TF32; the product reads lo's top 10 mantissa
// bits, so lo . b drops at most 2^-11 of lo, ~2^-22 of x
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// c += a . b, one m16n8k8 TF32 product with an f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m][n] += a[m] . b[n] for M x N output tiles in split TF32: the small
// products (lo . hi, then hi . lo) of every tile first, then hi . hi; M N
// accumulators in flight between two products into one of them.
template <int M, int N>
__device__ __forceinline__ void mma3(float (&acc)[M][N][4],
                                     const FragA (&a)[M],
                                     const FragB (&b)[N]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[m][n], a[m].lo, b[n].hi);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[m][n], a[m].hi, b[n].lo);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[m][n], a[m].hi, b[n].hi);
}

// sm[n] += a_lo . b[n]_hi + a_hi . b[n]_lo and bg[n] += a_hi . b[n]_hi: the
// split-TF32 product of one A fragment with N B fragments into two sets of
// accumulators (the small products and the large one), whose sum in f32 is
// the product. The large products then do not absorb the small ones in the
// tensor cores' truncating accumulation: the forward's 256-long S sums
// came out closer to float64 than with one accumulator.
template <int N>
__device__ __forceinline__ void mma3s(float (&sm)[N][4], float (&bg)[N][4],
                                      const FragA& a, const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(sm[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(bg[n], a.hi, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(sm[n], a.hi, b[n].lo);
}

// --- tiles ------------------------------------------------------------------

constexpr int D = 256;        // head dim (the MID-FC heads)

// element (r, c) of a swizzled [rows][TD] tile (TD = 256, or 128: K2 at
// d_model 256 in 2 heads; either row stride is a multiple of 32 banks, so
// one swizzle serves both)
template <int TD = D>
__device__ __forceinline__ int sw(int r, int c) {
  return r * TD + (c ^ (((r ^ (r >> 1)) & 3) << 3));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// A fragment from its raw entries: x0 = row g, x1 = row g + 8, columns
// 2t and 2t + 1 of the k-step
__device__ __forceinline__ void split_a(FragA& f, float2 x0, float2 x1) {
  split(x0.x, f.hi[0], f.lo[0]);
  split(x1.x, f.hi[1], f.lo[1]);
  split(x0.y, f.hi[2], f.lo[2]);
  split(x1.y, f.hi[3], f.lo[3]);
}

// B fragment from its raw entries: columns 2t and 2t + 1 of row n0 + g
__device__ __forceinline__ void split_b(FragB& f, float2 x) {
  split(x.x, f.hi[0], f.lo[0]);
  split(x.y, f.hi[1], f.lo[1]);
}

// B[k][n] = T[k0 + k][n0 + n] (B's rows are rows of the tile: dO, Q, K,
// V) of a swizzled [rows][TD] tile
template <int TD = D>
__device__ __forceinline__ void load_b_cols(FragB& f, const float* tile,
                                            int k0, int n0, int g, int t) {
  split(tile[sw<TD>(k0 + 2 * t, n0 + g)], f.hi[0], f.lo[0]);
  split(tile[sw<TD>(k0 + 2 * t + 1, n0 + g)], f.hi[1], f.lo[1]);
}

}  // namespace csn_tf32
