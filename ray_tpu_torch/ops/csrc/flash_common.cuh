// Pieces shared by the flash-attention kernels: the bf16 tensor-core product
// of the backward (flash_bwd.cu; mma.sync.m16n8k16, f32 accumulate), the
// packing of two values into one 32-bit fragment register (both kernels) and
// the LSE of an empty row (flash_fwd.cu).
//
// Fragment layout of m16n8k16 (lane = 4*g + t): A registers a0..a3 hold
// (row g, k 2t..2t+1), (row g+8, k 2t..2t+1), (row g, k 2t+8..9),
// (row g+8, k 2t+8..9); B registers b0, b1 hold (k 2t..2t+1, col g) and
// (k 2t+8..9, col g); the accumulator c0..c3 holds (row g, col 2t..2t+1) and
// (row g+8, col 2t..2t+1). So an accumulator's n-tiles 2j and 2j+1 are,
// rounded to bf16, the A fragment of k-step j of the next product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float LSE_EMPTY = -1e30f;  // LSE of a row with no valid key
constexpr int PAD = 8;  // bf16 elements of row padding in shared memory

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// A fragment of rows [r0, r0+16) and columns [c0, c0+16) of a row-major bf16
// tile in shared memory with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int r0, int c0, int g, int t) {
  const __nv_bfloat16* base = tile + (r0 + g) * ld + c0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(base);
  a[1] = *reinterpret_cast<const uint32_t*>(base + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(base + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(base + 8 * ld + 8);
}

// A fragment of k-step j from an accumulator's n-tiles 2j and 2j+1.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

// acc += A * B where B[k][n] = tile[k0 + k][n0 + n]: the B operand read down
// the rows of a row-major tile (V in P V, K in dS K, dO in P^T dO).
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int ld, int k0, int n0,
                                         int g, int t) {
  const __nv_bfloat16* base = tile + (k0 + 2 * t) * ld + n0 + g;
  mma_bf16(c, a, pack_bf16(base[0], base[ld]), pack_bf16(base[8 * ld], base[9 * ld]));
}

// acc += A * B where B[k][n] = tile[n0 + n][k0 + k]: the B operand read along
// the rows of a row-major tile (K in Q K^T, V in dO V^T, Q in K Q^T).
__device__ __forceinline__ void mma_cols(float (&c)[4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int ld, int n0, int k0,
                                         int g, int t) {
  const __nv_bfloat16* base = tile + (n0 + g) * ld + k0 + 2 * t;
  mma_bf16(c, a, *reinterpret_cast<const uint32_t*>(base),
           *reinterpret_cast<const uint32_t*>(base + 8));
}

}  // namespace
