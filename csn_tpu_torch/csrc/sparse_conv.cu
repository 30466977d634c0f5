// Sparse convolution forward over a precomputed kernel map.
//
// Replaces: csn_tpu/core/window_conv.py window_conv_fwd (Pallas bodies
// _tile_fwd_kernel and _wjobs_fwd_kernel), which the JAX package reaches
// through core/conv.py sparse_conv_tvjp.
//
// Computes out[i] = sum_k feats[kmap[k, i]] @ W[k] for i < n_out, where a
// kmap entry outside [0, n_in) (the sentinel n_in) adds nothing. Operands are
// read in the activation type (f32 or bf16), products accumulate in f32
// registers, and each output element is stored once in the activation type.
// The backward's d_feats is the same function over the transpose map with
// the paired weights transposed (core/conv.py conv_bwd_kernels).
//
// Two bodies, chosen by dtype and shape (as flash_attn.cu chooses by dtype
// and head dim; a failed launch of either returns its error, there is no
// retry on the other):
//  * bf16 with Cin % 16 == 0 and Cout % 8 == 0 (every conv of the HRNet and
//    U-Net families but the stems, whose Cin is 3): the tensor-core body
//    below, mma.sync m16n8k16 on bf16 operands with f32 accumulators;
//  * f32, and the stems: the CUDA-core body (f32 FMAs) after it.
//
// What bounds it on the H100: per output row and live offset one gathered
// row of Cin values and 2*Cin*Cout operations; the bound counts each input
// byte once (chip_smoke.py conv_work). Both bodies do more than that: the
// products run over every row of a tile at each offset where any of its
// rows is live (a sentinel row is zero-filled: no read, but its products
// run), and every row tile reads W[k] again (from L2: the W of one conv is
// at most a few MB).
//
// Tensor-core design. One block per tile of BM output rows x BN output
// channels, BN = 64 WN with WN = ceil(Cout / 64) up to 4 (a wider Cout
// takes several column tiles, spread evenly): the gather of a row feeds up
// to 256 output channels, where the CUDA-core body's BN = 64 gathered the
// same rows four times at Cout 256. BM = 64, and 128 at Cout <= 64, where
// the block would otherwise be two warps and W[k] is read again by every
// 64 rows. Warps of 32 rows x 64 channels (WM x WN of them) hold 64 f32
// accumulators a lane over all offsets; each output element is stored once
// in bf16, by exactly one block (no atomics: the same result on every
// run).
//  1. The block copies the tile's kmap rows of every offset into shared
//     memory (cp.async, 4 bytes each, all in flight together), marks
//     sentinels and rows past n_out, and finds the offsets with a live row
//     (a warp vote per offset); an offset with none is skipped.
//  2. It walks the steps (live offset, chunk of 64 input channels). A step
//     gathers its BM source rows straight from device memory / L2 by
//     cp.async, 16 bytes at a time (a sentinel row zero-filled, no read),
//     and W[k]'s [chunk x BN] slice the same way, into [rows][64 + 8] and
//     [64][BN + 8] bf16 tiles (rows 16 bytes apart modulo 128: ldmatrix
//     without bank conflicts, flash_tc.cuh's stride). Two stages: the next
//     step's copies are issued right after the barrier that publishes this
//     step's, before this step's products.
//  3. Per 16-channel k-step a warp loads its A fragments (ldmatrix) and the
//     B fragments of its 64 channels (ldmatrix.trans of the W tile) and
//     runs 16 mma.sync; channel blocks past Cout are skipped.
// The TPU kernel's windows, one-hot matmuls and job worklists are not
// carried over: a GPU gathers rows directly. wgmma and TMA are later work.
//
// CUDA-core design (f32, stems). One block per tile of 64 output rows x 64
// output channels. The block walks the offsets; per offset it stages the 64
// source-row indices in shared memory and skips the offset when every one
// is a sentinel, then walks Cin in chunks of 16: the gathered rows (zeros
// for a sentinel) and the W[k] slice go to shared memory in f32, and each
// of the 256 threads accumulates a 4 x 4 register tile.

#include "common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
sparse_conv_fwd_kernel(const T* __restrict__ feats,
                       const int32_t* __restrict__ kmap,
                       const T* __restrict__ w, T* __restrict__ out,
                       int64_t n_in, int64_t n_out, int n_off, int cin,
                       int cout) {
  __shared__ __align__(16) float As[BK][BM];  // gathered rows, channel-major
  __shared__ __align__(16) float Bs[BK][BN];  // W[k] slice
  __shared__ int64_t rows[BM];                // source row per output row

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < n_off; ++k) {
    int live = 0;
    if (tid < BM) {
      const int64_t i = m0 + tid;
      int64_t r = -1;
      if (i < n_out) {
        const int64_t v = kmap[(int64_t)k * n_out + i];
        if (v >= 0 && v < n_in) r = v;
      }
      rows[tid] = r;
      live = r >= 0;
    }
    // also the barrier that publishes rows[]
    if (!__syncthreads_or(live)) continue;

    for (int c0 = 0; c0 < cin; c0 += BK) {
      {  // A: row tid/4, channels (tid%4)*4 .. +3 of this chunk
        const int m = tid >> 2;
        const int cc = (tid & 3) * 4;
        const int64_t r = rows[m];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + cc + q;
          As[cc + q][m] =
              (r >= 0 && c < cin) ? csn::to_f32(feats[r * cin + c]) : 0.f;
        }
      }
      {  // B: channel tid/16 of this chunk, output channels (tid%16)*4 .. +3
        const int kk = tid >> 4;
        const int nn = (tid & 15) * 4;
        const int c = c0 + kk;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + nn + q;
          Bs[kk][nn + q] =
              (c < cin && n < cout)
                  ? csn::to_f32(w[((int64_t)k * cin + c) * cout + n])
                  : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + ty * 4 + i;
    if (row >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < cout) csn::store(acc[i][j], out + row * cout + col);
    }
  }
}

template <typename T>
cudaError_t launch(const void* feats, const void* kmap, const void* w,
                   void* out, int64_t n_in, int64_t n_out, int n_off, int cin,
                   int cout, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_out + BM - 1) / BM),
                  (unsigned)((cout + BN - 1) / BN));
  sparse_conv_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int32_t*>(kmap),
      static_cast<const T*>(w), static_cast<T*>(out), n_in, n_out, n_off, cin,
      cout);
  return cudaGetLastError();
}

// --- the tensor-core body (bf16, Cin % 16 == 0, Cout % 8 == 0) -------------

using csn_tc::bf16;
using csn_tc::cp_async16;
using csn_tc::cp_async_commit;
using csn_tc::cp_async_wait;
using csn_tc::ldsm_x4;
using csn_tc::ldsm_x4_t;
using csn_tc::mma;
using csn_tc::pack;
using csn_tc::smem_addr;

constexpr int TBK = 64;          // input channels per step
constexpr int LDA = TBK + 8;     // A tile row stride (flash_tc.cuh's LDS)

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

template <int WM, int WN>
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

  // the copies of step (k, c0) into stage st: BM gathered rows x kk input
  // channels, and W[k]'s kk x BN slice (channels past Cout zero-filled)
  auto load = [&](int st, int k, int c0) {
    const int kk = min(TBK, cin - c0);
    bf16* as = stages + st * Tl::STAGE_ELEMS;
    bf16* bs = as + Tl::A_ELEMS;
    const int32_t* rows = src + k * BM;
#pragma unroll
    for (int i = tid; i < BM * (TBK / 8); i += THREADS) {
      const int r = i / (TBK / 8), c = (i % (TBK / 8)) * 8;
      if (c < kk) {
        const int s = rows[r];
        cp_async16(as + r * LDA + c,
                   feats + (int64_t)(s >= 0 ? s : 0) * cin + c0 + c, s >= 0);
      }
    }
    const bf16* wk = w + ((int64_t)k * cin + c0) * cout;
#pragma unroll
    for (int i = tid; i < TBK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      if (r < kk) {
        const bool ok = n0 + c < cout;
        cp_async16(bs + r * LDB + c,
                   wk + (int64_t)r * cout + (ok ? n0 + c : 0), ok);
      }
    }
  };
  auto next_live = [&](int k) {
    while (k < n_off && !live[k]) ++k;
    return k;
  };

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
  if (k < n_off) load(0, k, 0);
  cp_async_commit();
  for (int st = 0; k < n_off; st ^= 1) {
    int k2 = k, c2 = c0 + TBK;
    if (c2 >= cin) k2 = next_live(k + 1), c2 = 0;
    cp_async_wait<0>();
    __syncthreads();
    if (k2 < n_off) load(st ^ 1, k2, c2);
    cp_async_commit();
    const bf16* as = stages + st * Tl::STAGE_ELEMS;
    const bf16* bs = as + Tl::A_ELEMS;
    const int nks = min(TBK, cin - c0) / 16;
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

template <int WM, int WN>
cudaError_t launch_tc_body(const void* feats, const void* kmap, const void* w,
                           void* out, int64_t n_in, int64_t n_out, int n_off,
                           int cin, int cout, cudaStream_t stream) {
  using Tl = TcTile<WM, WN>;
  const size_t smem = Tl::smem_bytes(n_off);
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_conv_fwd_tc_kernel<WM, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n_out + Tl::BM - 1) / Tl::BM),
                  (unsigned)((cout + Tl::BN - 1) / Tl::BN));
  sparse_conv_fwd_tc_kernel<WM, WN><<<grid, Tl::THREADS, smem, stream>>>(
      static_cast<const bf16*>(feats), static_cast<const int32_t*>(kmap),
      static_cast<const bf16*>(w), static_cast<bf16*>(out), n_in, n_out,
      n_off, cin, cout);
  return cudaGetLastError();
}

// BN = 64 WN: one column tile up to Cout 256, else ceil(Cout / 256) tiles of
// equal width (Cout 384: two of 192); BM = 128 at WN = 1, else 64
cudaError_t launch_tc(const void* feats, const void* kmap, const void* w,
                      void* out, int64_t n_in, int64_t n_out, int n_off,
                      int cin, int cout, cudaStream_t stream) {
  const int n64 = (cout + 63) / 64;
  const int tiles = (n64 + 3) / 4;
  const int wn = (n64 + tiles - 1) / tiles;
#define CSN_TC(WM, WN)                                                       \
  return launch_tc_body<WM, WN>(feats, kmap, w, out, n_in, n_out, n_off, cin, \
                                cout, stream)
  if (wn == 1) CSN_TC(4, 1);
  if (wn == 2) CSN_TC(2, 2);
  if (wn == 3) CSN_TC(2, 3);
  CSN_TC(2, 4);
#undef CSN_TC
}

}  // namespace

// feats [n_in, cin] and w [n_off, cin, cout] in one type (16-byte aligned
// for the tensor-core body), kmap [n_off, n_out] int32, out [n_out, cout].
extern "C" int csn_sparse_conv_fwd(int dtype, const void* feats,
                                   const void* kmap, const void* w, void* out,
                                   int64_t n_in, int64_t n_out, int n_off,
                                   int cin, int cout, void* stream) {
  if (n_out == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csn::kBF16 && cin % 16 == 0 && cout % 8 == 0)
    return launch_tc(feats, kmap, w, out, n_in, n_out, n_off, cin, cout, s);
  if (dtype == csn::kF32)
    return launch<float>(feats, kmap, w, out, n_in, n_out, n_off, cin, cout, s);
  if (dtype == csn::kBF16)
    return launch<__nv_bfloat16>(feats, kmap, w, out, n_in, n_out, n_off, cin,
                                 cout, s);
  return cudaErrorInvalidValue;
}
