// Shared helpers for the hand-written Hopper kernels: the bf16 tensor-core
// matrix product mma.sync.m16n8k16 (fp32 accumulate) and bf16 packing.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major), 4 regs: a0 = (row g,   cols 2t..2t+1)
//                                 a1 = (row g+8, cols 2t..2t+1)
//                                 a2 = (row g,   cols 2t+8..2t+9)
//                                 a3 = (row g+8, cols 2t+8..2t+9)
//   B (16x8, k-major),   2 regs: b0 = (k 2t..2t+1, col g), b1 = (k 2t+8..2t+9, col g)
//   C (16x8, fp32),      4 regs: c0,c1 = (row g, cols 2t, 2t+1), c2,c3 = (row g+8, ...)
// In every pair the lower-indexed element sits in the low 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pi3 {

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive bf16 values as one 32-bit register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values (lo, hi) from separate addresses as one register.
__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two fp32 values rounded to bf16 (round to nearest even) as one register.
__device__ __forceinline__ uint32_t pack_float2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace pi3
