// The tensor-core body of the sparse conv forward, shared by K1
// (sparse_conv.cu) and the im2col forward (sparse_conv_im2col.cu): out =
// IC @ W.reshape(K*Cin, Cout) with f32 accumulation, in two element types,
// each for both entries:
//  * bf16 with Cout % 8 == 0 and any Cin: mma.sync m16n8k16 on bf16
//    operands;
//  * f32 with Cout % 8 == 0 and any Cin: mma.sync m16n8k8 on TF32
//    operands in split TF32 (flash_tf32.cuh): each f32 operand is split in
//    registers, as its fragment is loaded, into hi = tf32(x) and lo = x -
//    hi, and a . b ~= a_lo . b_hi + a_hi . b_lo + a_hi . b_hi, the small
//    products first, into a fresh fragment per k-step that an f32 add puts
//    into the running sum. W is split again by every row tile that loads it
//    (two instructions per value, against three products per fragment
//    pair), so no kernel splits it ahead.
//
// One block per tile of BM output rows x BN output channels, BN = 64 WN with
// WN = ceil(Cout / 64) up to 4 (a wider Cout takes several column tiles,
// spread evenly): the gather of a row feeds up to 256 output channels. BM =
// 32 WM: WM = 4 at Cout <= 64, where the block would otherwise be two
// warps and W[k] is read again by every 64 rows, else WM = 2, halved where
// the kmap slab of many offsets would not fit (launch_tc_body). Warps of
// 32 rows x 64 channels (WM x WN of them) hold 64 f32 accumulators a lane
// over all steps; each output element is stored once in the activation
// type, by exactly one block (no atomics: the same result on every run).
// An output element's sum does not depend on WM, so a smaller WM gives the
// same bits.
//  1. The block copies the tile's kmap rows of every offset into shared
//     memory (cp.async, 4 bytes each, all in flight together), marks
//     sentinels and rows past n_out, and finds the offsets with a live row
//     (a warp vote per offset; f32: per offset and m16 tile).
//  2. It walks the steps of the contraction axis, TBK columns each (64
//     bf16 or 32 f32: 128 bytes of a row), and skips the steps that hold no
//     live offset:
//     * K1's steps (FLAT false, Cin % 16 == 0): (live offset k, chunk of
//       TBK input channels). A step gathers its BM source rows straight
//       from device memory / L2 by cp.async, 16 bytes at a time (a sentinel
//       row zero-filled, no read);
//     * flattened steps (FLAT true, Cin % 16 != 0: the k5 stem's Cin 3):
//       the columns j0 .. j0+TBK-1 of the flattened axis K*Cin, which span
//       offsets (the stem's 375 columns are 6 steps in bf16 and 12 in f32
//       where a walk by offset would take 125 that are 3 deep). Rows of Cin
//       values (6 or 12 bytes at the stem) are not 16-byte pieces, so the
//       step gathers element by element (2- or 4-byte loads; zero for a
//       sentinel and for the padding past K*Cin, up to the next k-step).
//     W's rows of the step (contiguous in W.reshape(K*Cin, Cout) either
//     way) come by cp.async 16 bytes at a time. Two stages: the next step's
//     copies are issued right after the barrier that publishes this step's,
//     before this step's products.
//  3. The products of a step, per k-step of 16 (bf16) or 8 (f32) columns:
//     * bf16: the tiles are [rows][64 + 8] and [64][BN + 8] (rows 16 bytes
//       apart modulo 128: ldmatrix without bank conflicts, flash_tc.cuh's
//       stride); a warp loads its A fragments (ldmatrix) and the B
//       fragments of its 64 channels (ldmatrix.trans of the W tile) and
//       runs 16 mma.sync;
//     * f32: the tiles are [rows][32 + 8] and [32][BN + 4] words, so the
//       fragments' loads (flash_tf32.cuh's layout: A two 8-byte loads at
//       rows g, g + 8 and columns 2t, 2t + 1; B two 4-byte loads at rows
//       2t, 2t + 1 and column g) hit 32 distinct banks, strides 8 and 4
//       modulo 32 words; a warp splits its 2 A fragments and one B
//       fragment at a time and runs 2 x 3 mma.sync per 8 channels into a
//       fresh fragment, which an f32 add puts into the running sum (the
//       tensor cores truncate the sum of every mma.sync). Three
//       products make the tensor cores the limit, so a warp skips an m16
//       tile whose 16 rows are all sentinels at the k-step's offsets (step
//       1 keeps a bit per m16 tile and offset; a flattened k-step spans up
//       to 4 offsets at the stem): its products would add exact zeros.
//       Live rows are sparse at most offsets (a quarter of the map entries
//       at HRNet's same-level maps, under a tenth at its up maps).
//     Channel blocks past Cout are skipped.
// A product runs over every row of the tile at each step that holds a live
// offset (a sentinel row is zero-filled: no read, but its products run).
// The TPU kernel's windows, one-hot matmuls and job worklists are not
// carried over: a GPU gathers rows directly. wgmma and TMA are later work.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "flash_tc.cuh"
#include "flash_tf32.cuh"

// Internal linkage: each .cu that includes this header gets its own kernels.
namespace csn_conv_tc {
namespace {

using csn_tc::bf16;
using csn_tc::cp_async16;
using csn_tc::cp_async_commit;
using csn_tc::cp_async_wait;
using csn_tc::ldsm_x4;
using csn_tc::ldsm_x4_t;
using csn_tc::mma;
using csn_tc::pack;
using csn_tc::smem_addr;

constexpr int MAX_SMEM = 232448; // dynamic shared memory a block may opt in

// The tiles of one element type: TBK columns of the contraction axis per
// step (128 bytes of a row), the A tile's row stride LDA and the W tile's
// row padding PAD_B (bf16: flash_tc.cuh's LDS; f32: strides of 8 and 4
// words modulo 32, see 3. above), elements per 16-byte copy VEC and per
// k-step KS.
template <typename T>
struct TcType;
template <>
struct TcType<bf16> {
  static constexpr int TBK = 64, LDA = TBK + 8, PAD_B = 8, VEC = 8, KS = 16;
};
template <>
struct TcType<float> {
  static constexpr int TBK = 32, LDA = TBK + 8, PAD_B = 4, VEC = 4, KS = 8;
};

// 4 bytes global -> shared, zero-filled when !ok (no global read then)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

template <typename T, int WM, int WN>
struct TcTile {
  static constexpr int BM = 32 * WM;  // output rows
  static constexpr int BN = 64 * WN;  // output channels
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TBK = TcType<T>::TBK, LDA = TcType<T>::LDA;
  static constexpr int LDB = BN + TcType<T>::PAD_B;  // W tile row stride
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + TBK * LDB;
  // two stages, then the kmap slab [n_off][BM] and the live flags [n_off]
  static size_t smem_bytes(int n_off) {
    return sizeof(T) * 2 * STAGE_ELEMS +
           sizeof(int32_t) * ((size_t)n_off * BM + n_off);
  }
};

// The f32 products of k-step ks (8 columns of the step's tiles) of a warp's
// 32 rows x 64 channels in split TF32, for the m16 tiles of mask MT (bit i:
// rows 16 i .. 16 i + 15 of the warp; a tile of sentinel rows would add
// exact zeros and is left out). One instantiation per mask keeps every
// accumulator index a constant. The three products go into a fresh
// fragment, added to the running sum by an f32 add: the tensor cores
// truncate each mma.sync's sum, which over the thousands of k-steps of a
// 512-channel, 27-offset output (3 x 1728 mma.sync into one accumulator)
// came within 3 % of the f32 checks' 1e-4 of max|ref|; added once per
// k-step in round-to-nearest, the error stays near the CUDA-core body's.
template <int MT, int LDA, int LDB>
__device__ __forceinline__ void tf32_kstep(float (&acc)[2][8][4],
                                           const float* as, const float* bs,
                                           int ks, int wm, int wn, int wc,
                                           int cout, int g, int t) {
  csn_tf32::FragA a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!(MT >> i & 1)) continue;
    const float* p = as + (32 * wm + 16 * i + g) * LDA + ks * 8 + 2 * t;
    csn_tf32::split_a(a[i], csn_tf32::ld2(p), csn_tf32::ld2(p + 8 * LDA));
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    if (wc + 8 * nb >= cout) break;
    const float* q = bs + (ks * 8 + 2 * t) * LDB + 64 * wn + 8 * nb + g;
    csn_tf32::FragB b;
    csn_tf32::split(q[0], b.hi[0], b.lo[0]);
    csn_tf32::split(q[LDB], b.hi[1], b.lo[1]);
    float part[2][4] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (MT >> i & 1) csn_tf32::mma_tf32(part[i], a[i].lo, b.hi);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (MT >> i & 1) csn_tf32::mma_tf32(part[i], a[i].hi, b.lo);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (MT >> i & 1) csn_tf32::mma_tf32(part[i], a[i].hi, b.hi);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (MT >> i & 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nb][e] += part[i][e];
  }
}

// The f32 products of one of K1's steps (nks k-steps, at most TBK / 8, all
// at one offset): one mask MT for the whole step.
template <int MT, int TBK, int LDA, int LDB>
__device__ __forceinline__ void tf32_step(float (&acc)[2][8][4],
                                          const float* as, const float* bs,
                                          int nks, int wm, int wn, int wc,
                                          int cout, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < TBK / 8; ++ks) {
    if (ks >= nks) break;
    tf32_kstep<MT, LDA, LDB>(acc, as, bs, ks, wm, wn, wc, cout, g, t);
  }
}

template <typename T, int WM, int WN, bool FLAT>
__global__ void __launch_bounds__(32 * WM * WN, 2)
sparse_conv_fwd_tc_kernel(const T* __restrict__ feats,
                          const int32_t* __restrict__ kmap,
                          const T* __restrict__ w, T* __restrict__ out,
                          int64_t n_in, int64_t n_out, int n_off, int cin,
                          int cout) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using Tl = TcTile<T, WM, WN>;
  constexpr int BM = Tl::BM, BN = Tl::BN, THREADS = Tl::THREADS;
  constexpr int TBK = Tl::TBK, LDA = Tl::LDA, LDB = Tl::LDB;
  constexpr int VEC = TcType<T>::VEC, KS = TcType<T>::KS;
  constexpr int NWARPS = THREADS / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  int32_t* src = reinterpret_cast<int32_t*>(stages + 2 * Tl::STAGE_ELEMS);
  int32_t* live = src + (size_t)n_off * BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kc = FLAT ? n_off * cin : 0;  // length of the flattened axis

  // 1. the tile's source rows at every offset (-1: no row), and the offsets
  // with a live row
  for (int i = tid; i < n_off * BM; i += THREADS) {
    const int k = i / BM, r = i % BM;
    const bool ok = m0 + r < n_out;
    cp_async4(src + i, kmap + (ok ? (int64_t)k * n_out + m0 + r : 0), ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int k = warp; k < n_off; k += NWARPS) {
    int any = 0;
    for (int r = lane; r < BM; r += 32) {
      const int v = src[k * BM + r];
      const bool ok = m0 + r < n_out && v >= 0 && v < n_in;
      src[k * BM + r] = ok ? v : -1;
      if constexpr (F32) {
        // bit j: a live row among rows 16 j .. 16 j + 15 (the m16 tiles;
        // rows r of this pass are 32 (r / 32) + lane)
        const unsigned b = __ballot_sync(0xffffffffu, ok);
        any |= ((b & 0xffffu ? 1 : 0) | (b >> 16 ? 2 : 0)) << (2 * (r / 32));
      } else {
        any |= ok;
      }
    }
    if constexpr (!F32) any = __any_sync(0xffffffffu, any);
    if (lane == 0) live[k] = any;
  }
  __syncthreads();

  // A step is (k, c0): K1's (offset, first input channel), or for FLAT
  // (first column of the flattened axis, unused). Its depth kk is a multiple
  // of the k-step KS (FLAT: zero-padded past K*Cin).
  auto depth = [&](int k, int c0) {
    if constexpr (FLAT) return (min(TBK, kc - k) + KS - 1) / KS * KS;
    return min(TBK, cin - c0);
  };
  // the copies of step (k, c0) into stage st: BM rows x kk columns of IC,
  // and the matching kk x BN rows of W (channels past Cout zero-filled)
  auto load = [&](int st, int k, int c0) {
    const int kk = depth(k, c0);
    T* as = stages + st * Tl::STAGE_ELEMS;
    T* bs = as + Tl::A_ELEMS;
    if constexpr (FLAT) {
      // a thread keeps its columns (one (offset, channel) division each)
      // and walks rows, CT columns and RT rows per pass of the block; all
      // of a column's loads are in flight before the first store
      constexpr int CT = THREADS % TBK == 0 ? TBK : 32;
      constexpr int RT = THREADS / CT;
      for (int c = tid % CT; c < kk; c += CT) {
        const int j = k + c;
        const int o = j < kc ? j / cin : n_off;  // n_off: padding, zeros
        const int32_t* rows = src + (size_t)min(o, n_off - 1) * BM;
        const T* fc = feats + (j - o * cin);
        constexpr int NQ = (BM + RT - 1) / RT;
        T v[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int r = tid / CT + q * RT;
          const int s = o < n_off && r < BM ? rows[r] : -1;
          if constexpr (F32)
            v[q] = s >= 0 ? fc[(int64_t)s * cin] : 0.f;
          else
            v[q] = s >= 0 ? fc[(int64_t)s * cin] : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          if (tid / CT + q * RT < BM) as[(tid / CT + q * RT) * LDA + c] = v[q];
      }
    } else {
      const int32_t* rows = src + k * BM;
#pragma unroll
      for (int i = tid; i < BM * (TBK / VEC); i += THREADS) {
        const int r = i / (TBK / VEC), c = (i % (TBK / VEC)) * VEC;
        if (c < kk) {
          const int s = rows[r];
          cp_async16(as + r * LDA + c,
                     feats + (int64_t)(s >= 0 ? s : 0) * cin + c0 + c,
                     s >= 0);
        }
      }
    }
    const int64_t w_row = FLAT ? (int64_t)k : (int64_t)k * cin + c0;
    const T* wk = w + w_row * cout;
#pragma unroll
    for (int i = tid; i < TBK * (BN / VEC); i += THREADS) {
      const int r = i / (BN / VEC), c = (i % (BN / VEC)) * VEC;
      if (r < kk) {
        const bool ok = n0 + c < cout && (!FLAT || k + r < kc);
        cp_async16(bs + r * LDB + c,
                   wk + (FLAT && !ok ? 0
                                     : (int64_t)r * cout + (ok ? n0 + c : 0)),
                   ok);
      }
    }
  };
  // the first live step at or after offset k (K1) / column j (FLAT);
  // n_off (K1) or >= kc (FLAT) when there is none
  auto next_live = [&](int k) {
    if constexpr (FLAT) {
      for (; k < kc; k += TBK) {
        const int k_hi = min(k + TBK, kc) - 1;
        int any = 0;
        for (int o = k / cin; o <= k_hi / cin; ++o) any |= live[o];
        if (any) break;
      }
      return k;
    }
    while (k < n_off && !live[k]) ++k;
    return k;
  };
  const int k_end = FLAT ? kc : n_off;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  const int wc = n0 + 64 * wn;  // the warp's first output channel
  const int g = lane >> 2, t = lane & 3;

  // 2.-3. the steps: one barrier each, which publishes this step's tiles and
  // orders every warp's reads of the other stage before its next copy
  int k = next_live(0), c0 = 0;
  if (k < k_end) load(0, k, 0);
  cp_async_commit();
  for (int st = 0; k < k_end; st ^= 1) {
    int k2 = k, c2 = c0 + TBK;
    if (FLAT) {
      k2 = next_live(k + TBK), c2 = 0;
    } else if (c2 >= cin) {
      k2 = next_live(k + 1), c2 = 0;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (k2 < k_end) load(st ^ 1, k2, c2);
    cp_async_commit();
    const T* as = stages + st * Tl::STAGE_ELEMS;
    const T* bs = as + Tl::A_ELEMS;
    const int nks = depth(k, c0) / KS;
    if constexpr (F32 && FLAT) {
      // per k-step, the warp's m16 tiles with a live row at one of the
      // offsets its 8 columns span (up to 4 at Cin 3)
      if (wc < cout)
#pragma unroll 1
        for (int ks = 0; ks < nks; ++ks) {
          const int j = k + 8 * ks, j_hi = min(j + 8, kc) - 1;
          int any = 0;
          for (int o = j / cin; o <= j_hi / cin; ++o) any |= live[o];
          const int mt = any >> (2 * wm) & 3;
          if (mt == 3)
            tf32_kstep<3, LDA, LDB>(acc, as, bs, ks, wm, wn, wc, cout, g, t);
          else if (mt == 1)
            tf32_kstep<1, LDA, LDB>(acc, as, bs, ks, wm, wn, wc, cout, g, t);
          else if (mt == 2)
            tf32_kstep<2, LDA, LDB>(acc, as, bs, ks, wm, wn, wc, cout, g, t);
        }
    } else if constexpr (F32) {
      // the warp's m16 tiles with a live row at offset k: a tile of
      // sentinel rows (zero-filled A) would add exact zeros
      const int mt = live[k] >> (2 * wm) & 3;
      if (wc < cout && mt == 3)
        tf32_step<3, TBK, LDA, LDB>(acc, as, bs, nks, wm, wn, wc, cout, g, t);
      else if (wc < cout && mt == 1)
        tf32_step<1, TBK, LDA, LDB>(acc, as, bs, nks, wm, wn, wc, cout, g, t);
      else if (wc < cout && mt == 2)
        tf32_step<2, TBK, LDA, LDB>(acc, as, bs, nks, wm, wn, wc, cout, g, t);
    } else if (wc < cout) {
#pragma unroll
      for (int ks = 0; ks < TBK / KS; ++ks) {
        if (ks >= nks) break;
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(a[i], as + (32 * wm + 16 * i + (lane & 15)) * LDA +
                            ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nb2 = 0; nb2 < 4; ++nb2) {
          if (wc + 16 * nb2 >= cout) break;
          uint32_t b[4];
          ldsm_x4_t(b, bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LDB +
                           64 * wn + nb2 * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma(acc[i][2 * nb2], a[i], b[0], b[1]);
            mma(acc[i][2 * nb2 + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    k = k2, c0 = c2;
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = m0 + 32 * wm + 16 * i + g + 8 * h;
      if (row >= n_out) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = wc + 8 * n + 2 * t;
        if (col >= cout) continue;
        if constexpr (F32)
          *reinterpret_cast<float2*>(out + row * cout + col) =
              make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
        else
          *reinterpret_cast<uint32_t*>(out + row * cout + col) =
              pack(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
      }
    }
}

// Halves WM (down to 2 at WN = 1, else 1) while the kmap slab of n_off
// offsets does not fit beside the stages (the im2col wrapper takes up to
// 640 offsets; at the models' 125 or fewer every tile fits). An output
// element's sum does not depend on WM, so the bits are the same either way.
template <typename T, int WM, int WN, bool FLAT>
cudaError_t launch_tc_body(const void* feats, const void* kmap, const void* w,
                           void* out, int64_t n_in, int64_t n_out, int n_off,
                           int cin, int cout, cudaStream_t stream) {
  using Tl = TcTile<T, WM, WN>;
  const size_t smem = Tl::smem_bytes(n_off);
  if constexpr (WM > (WN == 1 ? 2 : 1)) {
    if (smem > MAX_SMEM)
      return launch_tc_body<T, WM / 2, WN, FLAT>(
          feats, kmap, w, out, n_in, n_out, n_off, cin, cout, stream);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_conv_fwd_tc_kernel<T, WM, WN, FLAT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n_out + Tl::BM - 1) / Tl::BM),
                  (unsigned)((cout + Tl::BN - 1) / Tl::BN));
  sparse_conv_fwd_tc_kernel<T, WM, WN, FLAT>
      <<<grid, Tl::THREADS, smem, stream>>>(
          static_cast<const T*>(feats), static_cast<const int32_t*>(kmap),
          static_cast<const T*>(w), static_cast<T*>(out), n_in, n_out, n_off,
          cin, cout);
  return cudaGetLastError();
}

// WN of Cout's column tiles: BN = 64 WN, one tile up to Cout 256, else
// ceil(Cout / 256) tiles of equal width (Cout 384: two of 192)
int tc_wn(int cout) {
  const int n64 = (cout + 63) / 64;
  const int tiles = (n64 + 3) / 4;
  return (n64 + tiles - 1) / tiles;
}

// The tiles of both entries: BM = 128 at WN = 1, else 64 (fewer rows
// where the kmap slab needs it, launch_tc_body), in both element types.
template <bool FLAT, typename T = bf16>
cudaError_t launch_tc(const void* feats, const void* kmap, const void* w,
                      void* out, int64_t n_in, int64_t n_out, int n_off,
                      int cin, int cout, cudaStream_t stream) {
  const int wn = tc_wn(cout);
#define CSN_TC(WM, WN)                                                      \
  return launch_tc_body<T, WM, WN, FLAT>(feats, kmap, w, out, n_in, n_out, \
                                         n_off, cin, cout, stream)
  if (wn == 1) CSN_TC(4, 1);
  if (wn == 2) CSN_TC(2, 2);
  if (wn == 3) CSN_TC(2, 3);
  CSN_TC(2, 4);
#undef CSN_TC
}

}  // namespace
}  // namespace csn_conv_tc
