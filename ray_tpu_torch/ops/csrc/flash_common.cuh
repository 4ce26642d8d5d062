// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the packing of two f32 values into one bf16x2 fragment register, exp2 on
// the special-function unit, the store of a wgmma accumulator into a
// swizzled tile, and the LSE of an empty row. A wgmma accumulator's n-tiles
// 2kk and 2kk + 1, rounded to bf16 and packed in pairs, are the A fragment
// of k step kk of the next product (layouts in hopper.cuh).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float LSE_EMPTY = -1e30f;  // LSE of a row with no valid key

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// mul[r] * acc, an m64nD accumulator of this warpgroup (row r of the
// thread's two scaled by mul[r]), as bf16 into a 128-byte swizzled tile whose
// row 0 is at `rows` (generic address, a multiple of 8 rows into its chunk),
// chunks `chunk` bytes apart: the layout a TMA store of the tile reads.
template <int D>
__device__ __forceinline__ void store_acc_sw128(unsigned char* rows, int chunk,
                                                const float (&acc)[D / 2],
                                                const float (&mul)[2], int rl0, int t4) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<uint32_t*>(rows + (d / 64) * chunk +
                                   hopper::sw128_offset(rl0 + 8 * r, d % 64)) =
          pack_f32(acc[4 * j + 2 * r] * mul[r], acc[4 * j + 2 * r + 1] * mul[r]);
    }
  }
}

}  // namespace
