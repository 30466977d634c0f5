// 16-byte row pieces of the interpolation pair's wide bodies (interp.cu,
// interp_bwd.cu): a lane reads and writes VEC consecutive channels of a
// feature row at once, VEC 4 f32 or 8 bf16, which needs the row's address
// at that piece to be 16-byte aligned (the wrappers pick the body,
// core/interp_window.py `row_vector`). Values widen to f32 exactly and
// narrow by round to nearest even, as csn::store does one element at a
// time, so the wide and scalar bodies give the same bits.
#pragma once

#include "common.cuh"

namespace csn_interp {

constexpr unsigned kFull = 0xffffffffu;

// One piece as it sits in memory.
template <typename T, int VEC>
struct Piece;

template <>
struct Piece<float, 4> {
  float4 v;
};
template <>
struct Piece<__nv_bfloat16, 8> {
  uint4 v;
};

template <typename T, int VEC>
__device__ __forceinline__ Piece<T, VEC> load_piece(const T* p) {
  return *reinterpret_cast<const Piece<T, VEC>*>(p);
}

// Channel k of the piece, widened to f32.
__device__ __forceinline__ float piece_at(const Piece<float, 4>& x, int k) {
  return k == 0 ? x.v.x : k == 1 ? x.v.y : k == 2 ? x.v.z : x.v.w;
}
__device__ __forceinline__ float piece_at(const Piece<__nv_bfloat16, 8>& x,
                                          int k) {
  const uint32_t word = k < 2 ? x.v.x : k < 4 ? x.v.y : k < 6 ? x.v.z : x.v.w;
  // bf16 -> f32 is the 16 bits moved to the top of the word
  return __uint_as_float((k & 1) ? (word & 0xffff0000u) : (word << 16));
}

__device__ __forceinline__ void store_piece(const float (&a)[4], float* p) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_piece(const float (&a)[8],
                                            __nv_bfloat16* p) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * k], a[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

}  // namespace csn_interp
