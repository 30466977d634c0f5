// Tensor-core building blocks of the bf16 flash attention kernels at head
// dims TD = 16, 32, 64 and 128 (the forward of flash_tc_fwd.cuh, K2's and
// the ring's carry form; the backward of flash_tc_bwd.cuh up to 64, K2's
// and the ring's block form): asynchronous global -> shared copies
// (cp.async), fragment loads from shared memory (ldmatrix), the m16n8k16
// bf16 product with f32 accumulation (mma.sync), all as inline PTX for
// sm_80 and later, the attention-dropout words of one accumulator fragment
// (at a key column that is a multiple of 4, or any), and the carry in and
// out of the carry forms whose warps own whole rows of the head (these and
// the split-TF32 ones at D = 64 and 128, which share the C-fragment
// layout).
//
// Tiles. A 64-row x TD-column bf16 tile (Q, K, V, dO) lives in shared
// memory with a row stride of lds_of(TD) = TD + 8 elements (48, 80 or 144
// bytes); the 64 x 64 probability and dS tiles of the backward with LDS =
// 72. Each stride is an odd multiple of 16 bytes (3, 5, 9), so the eight
// 16-byte rows that one ldmatrix phase reads start at eight distinct
// 16-byte offsets modulo 128: distinct banks. What changes with TD: the
// 16-byte pieces a row copies (TD / 8), the k-steps of S = Q K^T (TD / 16)
// and the 8-column n-tiles of O, dQ, dK and dV (TD / 8). A score tile is 64
// keys wide at every TD.
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16"), lane = 4 g + t:
//  * A (16 x 16, row): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g,
//    2t+8..), a3 = (g+8, 2t+8..), two bf16 per register, lower column in
//    the low half.
//  * B (16 x 8, col): b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g).
//  * C (16 x 8, f32): c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// Two C fragments side by side (columns 16j .. 16j+15) are, rounded to
// bf16, the A fragment of the product's k-step j: P stays in registers
// between S = Q K^T and O += P V.

#pragma once

#include "common.cuh"

namespace csn_tc {

constexpr int TILE = 64;      // rows of a query or key tile
constexpr int LDS = TILE + 8; // row stride of a 64-column tile (elements)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// row stride (elements) of a [64][TD] tile
__host__ __device__ constexpr int lds_of(int td) { return td + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (no global read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0+ROWS-1 of a [L, TD] bf16 matrix into a [ROWS][lds_of(TD)]
// tile; rows at or past L are zeros. Every thread of the block (nthreads)
// takes part.
template <int TD, int ROWS = TILE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int L, int tid, int nthreads) {
  for (int i = tid; i < ROWS * (TD / 8); i += nthreads) {
    const int r = i / (TD / 8), c = (i % (TD / 8)) * 8;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * lds_of(TD) + c,
               src + (int64_t)(ok ? r0 + r : 0) * TD + c, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores (bf16 operands, f32 accumulator)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A fragments of the 16 rows of a warp from a [64][lds_of(TD)] tile,
// rows row0 .. row0+15, for the TD / 16 16-column k-steps: a[ks] = columns
// 16 ks .. 16 ks+15.
template <int TD>
__device__ __forceinline__ void load_a(uint32_t (&a)[TD / 16][4],
                                       const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int ks = 0; ks < TD / 16; ++ks)
    ldsm_x4(a[ks], tile + (row0 + (lane & 15)) * lds_of(TD) + ks * 16 +
                       (lane >> 4) * 8);
}

// The A fragment of k-step ks of T^T for the 16 columns col0 .. col0+15 of
// a [64][LDS] tile T: A's rows are T's columns, A's k-step ks is T's rows
// 16 ks .. 16 ks+15 (ldmatrix.trans: P^T and dS^T off their tiles).
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* tile,
                                         int col0, int ks, int lane) {
  ldsm_x4_t(a, tile + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + col0 +
                   ((lane >> 3) & 1) * 8);
}

// acc[16 x 64] += A (rows of the warp, TD / 16 k-steps of 16 over the
// tile's columns) . T^T, T a [64][lds_of(TD)] tile whose rows are the 64
// output columns: S = Q K^T and dP = dO V^T. acc[nb] holds output columns
// 8 nb .. 8 nb+7.
template <int TD>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[TD / 16][4],
                                        const bf16* t, int lane) {
#pragma unroll
  for (int ks = 0; ks < TD / 16; ++ks)
#pragma unroll
    for (int nb2 = 0; nb2 < 4; ++nb2) {
      uint32_t b[4];
      ldsm_x4(b, t + (nb2 * 16 + (lane & 7) + (lane >> 4) * 8) *
                         lds_of(TD) + ks * 16 + ((lane >> 3) & 1) * 8);
      mma(acc[2 * nb2], a[ks], b[0], b[1]);
      mma(acc[2 * nb2 + 1], a[ks], b[2], b[3]);
    }
}

// acc[16 x TD] += A(ks) . T[16 ks .. 16 ks+15][0..TD-1] for one k-step:
// the B operand is rows of a [64][lds_of(TD)] tile (V, K, dO or Q), read
// transposed.
template <int TD>
__device__ __forceinline__ void mma_ab_step(float (&acc)[TD / 8][4],
                                            const uint32_t (&a)[4],
                                            const bf16* t, int ks, int lane) {
#pragma unroll
  for (int db2 = 0; db2 < TD / 16; ++db2) {
    uint32_t b[4];
    ldsm_x4_t(b, t + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                           lds_of(TD) + db2 * 16 + (lane >> 4) * 8);
    mma(acc[2 * db2], a, b[0], b[1]);
    mma(acc[2 * db2 + 1], a, b[2], b[3]);
  }
}

// The A fragment of k-step ks made of C fragments 2 ks and 2 ks+1 of x,
// rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&x)[8][4], int ks) {
  a[0] = pack(x[2 * ks][0], x[2 * ks][1]);
  a[1] = pack(x[2 * ks][2], x[2 * ks][3]);
  a[2] = pack(x[2 * ks + 1][0], x[2 * ks + 1][1]);
  a[3] = pack(x[2 * ks + 1][2], x[2 * ks + 1][3]);
}

// The dropout words of one C fragment: rows `row` (the lane's g) and row+8,
// columns col0 + 2t, col0 + 2t + 1 (col0 a multiple of 8), as w[e] for
// fragment entry e. Both columns lie in Philox group (col0 + 2t) / 4, words
// 2(t & 1) and 2(t & 1)+1, and lanes t and t^1 share that group: the even
// lane draws it for row, the odd lane for row+8, and they swap the two
// words the other needs. One Philox call per lane and fragment.
__device__ __forceinline__ void drop_words(uint32_t (&w)[4], uint64_t seed,
                                           uint32_t bh, uint32_t row,
                                           uint32_t col0, int t) {
  const bool odd = t & 1;
  const csn::U4 r = csn::dropout_bits(seed, bh, row + (odd ? 8u : 0u),
                                      (col0 + 2u * t) >> 2);
  const uint32_t own0 = odd ? r.z : r.x, own1 = odd ? r.w : r.y;
  const uint32_t rcv0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
  const uint32_t rcv1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
  w[0] = odd ? rcv0 : own0;
  w[1] = odd ? rcv1 : own1;
  w[2] = odd ? own0 : rcv0;
  w[3] = odd ? own1 : rcv1;
}

// The keep bits of a warp's 16 x 64 tile for this lane: bit 4 nb + e is
// entry e of C fragment nb (drop_words per fragment, kept when the word is
// below thresh). The bits depend on positions only: the backward passes
// draw them right after issuing the tile's S and dP products, so the Philox
// arithmetic runs on the ALUs while the tensor cores work.
__device__ __forceinline__ uint32_t keep_bits(uint64_t seed, uint32_t bh,
                                              uint32_t row, uint32_t col0,
                                              uint32_t thresh, int t) {
  uint32_t bits = 0u;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    uint32_t w[4];
    drop_words(w, seed, bh, row, col0 + nb * 8, t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bits |= (w[e] < thresh ? 1u : 0u) << (4 * nb + e);
  }
  return bits;
}

// The keep bits of N C fragments of 8 columns from col0 at any alignment:
// keep_bits' layout (bit 4 n + e), for a ring hop's key block, which may
// start inside a 4-column Philox group (col_off = origin * Lk), where
// drop_words' lane pairs no longer share a group. Each lane draws its own
// two columns of each fragment row with csn::dropout_words: one or two
// Philox calls a run, up to four times drop_words' one call a fragment.
template <int N = 8>
__device__ __forceinline__ uint32_t keep_bits_any(uint64_t seed, uint32_t bh,
                                                  uint32_t row, uint32_t col0,
                                                  uint32_t thresh, int t) {
  uint32_t bits = 0u;
#pragma unroll
  for (int n = 0; n < N; ++n) {  // rows row, row + 8; columns 2t, 2t + 1
    uint32_t w0[2], w1[2];
    csn::dropout_words<2>(seed, bh, row, col0 + 8 * n + 2 * t, w0);
    csn::dropout_words<2>(seed, bh, row + 8u, col0 + 8 * n + 2 * t, w1);
    const uint32_t w[4] = {w0[0], w0[1], w1[0], w1[1]};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bits |= (w[e] < thresh ? 1u : 0u) << (4 * n + e);
  }
  return bits;
}

// Thread tid's flag of row tid of tile t of ROWS rows (threads below ROWS;
// 0 for rows at or past L): a load the caller issues a tile ahead of its use.
template <int ROWS = TILE>
__device__ __forceinline__ int row_live(const uint8_t* mask, int L, int t,
                                        int tid) {
  const int r = t * ROWS + tid;
  return tid < ROWS && r < L && mask[r];
}

// The first tile at or after t (of nt) with a true mask byte, given `live`
// = row_live<ROWS>(mask, L, t, tid); on return `live` is the flag of the
// tile found. One barrier per tile probed and at least one, which also
// publishes the shared memory written before the call.
template <int ROWS = TILE>
__device__ __forceinline__ int find_live(int t, int nt, int& live,
                                         const uint8_t* mask, int L,
                                         int tid) {
  for (;;) {
    const int any = __syncthreads_or(live);
    if (t >= nt || any) return t;
    live = row_live<ROWS>(mask, L, ++t, tid);
  }
}

// The 4 warps of a 32-row strip meet (named barrier 1 + strip; barrier 0 is
// __syncthreads'): the bodies whose warps split D in quarters.
__device__ __forceinline__ void strip_sync(int strip) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + strip));
}

// The carry in of the lane's rows `row` and row + 8 (those below Lq), for
// the carry forms whose warps own 16 query rows over the whole head of TD
// dims (flash_tc_fwd.cuh; flash_tf32_d64_fwd.cuh, flash_tf32_d128_fwd.cuh):
// m_in in the bodies' log2 units; l_in on lane t = 0 of the row's quad (0
// on the others: the denominator is summed per lane and reduced over the
// quad at the end, so a rescale applies to each lane's partial sum);
// acc_in at the lane's C-fragment positions of O, dims 8 n + 2 t (+ 1).
template <int TD>
__device__ __forceinline__ void carry_in(const csn::Carry& cy,
                                         int64_t row_base, int row, int Lq,
                                         int t, float (&m)[2], float (&l)[2],
                                         float (&o)[TD / 8][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= Lq) continue;
    m[h] = cy.m_in[row_base + r] * LOG2E;
    l[h] = t == 0 ? cy.l_in[row_base + r] : 0.f;
    const float* ai = cy.acc_in + (row_base + r) * TD + 2 * t;
#pragma unroll
    for (int n = 0; n < TD / 8; ++n) {
      const float2 a = *reinterpret_cast<const float2*>(ai + 8 * n);
      o[n][2 * h] = a.x;
      o[n][2 * h + 1] = a.y;
    }
  }
}

// The carry out of row rr of the carry (below Lq) from the lane's half h
// of its C fragments, as carry_in reads it: m in natural units, the
// quad-reduced l and O undivided; or the carry in, bit for bit, where the
// row passes through (`through`: no live key tile in the block, or a
// padding row)
template <int TD>
__device__ __forceinline__ void carry_out(const csn::Carry& cy, int64_t rr,
                                          bool through, int h, int t,
                                          float m, float l,
                                          const float (&o)[TD / 8][4]) {
  float* ao = cy.acc_out + rr * TD + 2 * t;
  if (through) {
    const float* ai = cy.acc_in + rr * TD + 2 * t;
#pragma unroll
    for (int n = 0; n < TD / 8; ++n)
      *reinterpret_cast<float2*>(ao + 8 * n) =
          *reinterpret_cast<const float2*>(ai + 8 * n);
  } else {
#pragma unroll
    for (int n = 0; n < TD / 8; ++n)
      *reinterpret_cast<float2*>(ao + 8 * n) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
  }
  if (t == 0) {
    cy.m_out[rr] = through ? cy.m_in[rr] : m * LN2;
    cy.l_out[rr] = through ? cy.l_in[rr] : l;
  }
}

// 2^x, flushing results below 2^-126 to zero (probabilities that small
// add nothing to an f32 sum of terms up to 1)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace csn_tc
