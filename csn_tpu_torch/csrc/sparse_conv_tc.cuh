// The tensor-core body of the sparse conv forward, shared by K1
// (sparse_conv.cu) and the im2col forward (sparse_conv_im2col.cu), both at
// bf16 with Cout % 8 == 0 and any Cin: out = IC @ W.reshape(K*Cin, Cout) in
// bf16 with f32 accumulation, mma.sync m16n8k16.
//
// One block per tile of BM output rows x BN output channels, BN = 64 WN with
// WN = ceil(Cout / 64) up to 4 (a wider Cout takes several column tiles,
// spread evenly): the gather of a row feeds up to 256 output channels. BM =
// 32 WM: WM = 4 at Cout <= 64, where the block would otherwise be two
// warps and W[k] is read again by every 64 rows, else WM = 2, halved where
// the kmap slab of many offsets would not fit (launch_tc_body). Warps of
// 32 rows x 64 channels (WM x WN of them) hold 64 f32 accumulators a lane
// over all steps; each output element is stored once in bf16, by exactly one
// block (no atomics: the same result on every run). An output element's sum
// does not depend on WM, so a smaller WM gives the same bits.
//  1. The block copies the tile's kmap rows of every offset into shared
//     memory (cp.async, 4 bytes each, all in flight together), marks
//     sentinels and rows past n_out, and finds the offsets with a live row
//     (a warp vote per offset).
//  2. It walks the steps of the contraction axis, 64 columns each, and
//     skips the steps that hold no live offset:
//     * K1's steps (FLAT false, Cin % 16 == 0): (live offset k, chunk of 64
//       input channels). A step gathers its BM source rows straight from
//       device memory / L2 by cp.async, 16 bytes at a time (a sentinel row
//       zero-filled, no read);
//     * flattened steps (FLAT true, Cin % 16 != 0: the k5 stem's Cin 3):
//       the columns j0 .. j0+63 of the flattened axis K*Cin, which span
//       offsets (the stem's 375 columns are 6 steps where a walk by offset
//       would take 125 that are 3 deep). Rows of Cin bf16 values are not 16-byte pieces, so the
//       step gathers element by element (2-byte loads; zero for a sentinel
//       and for the padding past K*Cin).
//     W's rows of the step (contiguous in W.reshape(K*Cin, Cout) either
//     way) come by cp.async 16 bytes at a time. The tiles are [rows][64 + 8]
//     and [64][BN + 8] bf16 (rows 16 bytes apart modulo 128: ldmatrix
//     without bank conflicts, flash_tc.cuh's stride). Two stages: the next
//     step's copies are issued right after the barrier that publishes this
//     step's, before this step's products.
//  3. Per 16-column k-step a warp loads its A fragments (ldmatrix) and the
//     B fragments of its 64 channels (ldmatrix.trans of the W tile) and
//     runs 16 mma.sync; channel blocks past Cout are skipped.
// A product runs over every row of the tile at each step that holds a live
// offset (a sentinel row is zero-filled: no read, but its products run).
// The TPU kernel's windows, one-hot matmuls and job worklists are not
// carried over: a GPU gathers rows directly. wgmma and TMA are later work.
#pragma once

#include "common.cuh"
#include "flash_tc.cuh"

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

constexpr int TBK = 64;          // columns of the contraction axis per step
constexpr int LDA = TBK + 8;     // A tile row stride (flash_tc.cuh's LDS)
constexpr int MAX_SMEM = 232448; // dynamic shared memory a block may opt in

// 4 bytes global -> shared, zero-filled when !ok (no global read then)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

template <int WM, int WN>
struct TcTile {
  static constexpr int BM = 32 * WM;  // output rows
  static constexpr int BN = 64 * WN;  // output channels
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int LDB = BN + 8;  // W tile row stride
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + TBK * LDB;
  // two stages, then the kmap slab [n_off][BM] and the live flags [n_off]
  static size_t smem_bytes(int n_off) {
    return sizeof(bf16) * 2 * STAGE_ELEMS +
           sizeof(int32_t) * ((size_t)n_off * BM + n_off);
  }
};

template <int WM, int WN, bool FLAT>
__global__ void __launch_bounds__(32 * WM * WN, 2)
sparse_conv_fwd_tc_kernel(const bf16* __restrict__ feats,
                          const int32_t* __restrict__ kmap,
                          const bf16* __restrict__ w, bf16* __restrict__ out,
                          int64_t n_in, int64_t n_out, int n_off, int cin,
                          int cout) {
  using Tl = TcTile<WM, WN>;
  constexpr int BM = Tl::BM, BN = Tl::BN, THREADS = Tl::THREADS;
  constexpr int LDB = Tl::LDB, NWARPS = THREADS / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
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
      any |= ok;
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) live[k] = any;
  }
  __syncthreads();

  // A step is (k, c0): K1's (offset, first input channel), or for FLAT
  // (first column of the flattened axis, unused). Its depth kk is a multiple
  // of 16 (FLAT: zero-padded past K*Cin).
  auto depth = [&](int k, int c0) {
    if constexpr (FLAT) return (min(TBK, kc - k) + 15) / 16 * 16;
    return min(TBK, cin - c0);
  };
  // the copies of step (k, c0) into stage st: BM rows x kk columns of IC,
  // and the matching kk x BN rows of W (channels past Cout zero-filled)
  auto load = [&](int st, int k, int c0) {
    const int kk = depth(k, c0);
    bf16* as = stages + st * Tl::STAGE_ELEMS;
    bf16* bs = as + Tl::A_ELEMS;
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
        const bf16* fc = feats + (j - o * cin);
        constexpr int NQ = (BM + RT - 1) / RT;
        bf16 v[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int r = tid / CT + q * RT;
          const int s = o < n_off && r < BM ? rows[r] : -1;
          v[q] = s >= 0 ? fc[(int64_t)s * cin] : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          if (tid / CT + q * RT < BM) as[(tid / CT + q * RT) * LDA + c] = v[q];
      }
    } else {
      const int32_t* rows = src + k * BM;
#pragma unroll
      for (int i = tid; i < BM * (TBK / 8); i += THREADS) {
        const int r = i / (TBK / 8), c = (i % (TBK / 8)) * 8;
        if (c < kk) {
          const int s = rows[r];
          cp_async16(as + r * LDA + c,
                     feats + (int64_t)(s >= 0 ? s : 0) * cin + c0 + c,
                     s >= 0);
        }
      }
    }
    const int64_t w_row = FLAT ? (int64_t)k : (int64_t)k * cin + c0;
    const bf16* wk = w + w_row * cout;
#pragma unroll
    for (int i = tid; i < TBK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
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
    const bf16* as = stages + st * Tl::STAGE_ELEMS;
    const bf16* bs = as + Tl::A_ELEMS;
    const int nks = depth(k, c0) / 16;
    if (wc < cout) {
#pragma unroll
      for (int ks = 0; ks < TBK / 16; ++ks) {
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

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = m0 + 32 * wm + 16 * i + g + 8 * h;
      if (row >= n_out) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = wc + 8 * n + 2 * t;
        if (col < cout)
          *reinterpret_cast<uint32_t*>(out + row * cout + col) =
              pack(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
      }
    }
}

// Halves WM (down to 2 at WN = 1, else 1) while the kmap slab of n_off
// offsets does not fit beside the stages (the im2col wrapper takes up to
// 640 offsets; at the models' 125 or fewer every tile fits). An output
// element's sum does not depend on WM, so the bits are the same either way.
template <int WM, int WN, bool FLAT>
cudaError_t launch_tc_body(const void* feats, const void* kmap, const void* w,
                           void* out, int64_t n_in, int64_t n_out, int n_off,
                           int cin, int cout, cudaStream_t stream) {
  using Tl = TcTile<WM, WN>;
  const size_t smem = Tl::smem_bytes(n_off);
  if constexpr (WM > (WN == 1 ? 2 : 1)) {
    if (smem > MAX_SMEM)
      return launch_tc_body<WM / 2, WN, FLAT>(feats, kmap, w, out, n_in,
                                              n_out, n_off, cin, cout, stream);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_conv_fwd_tc_kernel<WM, WN, FLAT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n_out + Tl::BM - 1) / Tl::BM),
                  (unsigned)((cout + Tl::BN - 1) / Tl::BN));
  sparse_conv_fwd_tc_kernel<WM, WN, FLAT><<<grid, Tl::THREADS, smem, stream>>>(
      static_cast<const bf16*>(feats), static_cast<const int32_t*>(kmap),
      static_cast<const bf16*>(w), static_cast<bf16*>(out), n_in, n_out,
      n_off, cin, cout);
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
// where the kmap slab needs it, launch_tc_body)
template <bool FLAT>
cudaError_t launch_tc(const void* feats, const void* kmap, const void* w,
                      void* out, int64_t n_in, int64_t n_out, int n_off,
                      int cin, int cout, cudaStream_t stream) {
  const int wn = tc_wn(cout);
#define CSN_TC(WM, WN)                                                   \
  return launch_tc_body<WM, WN, FLAT>(feats, kmap, w, out, n_in, n_out, \
                                      n_off, cin, cout, stream)
  if (wn == 1) CSN_TC(4, 1);
  if (wn == 2) CSN_TC(2, 2);
  if (wn == 3) CSN_TC(2, 3);
  CSN_TC(2, 4);
#undef CSN_TC
}

}  // namespace
}  // namespace csn_conv_tc
