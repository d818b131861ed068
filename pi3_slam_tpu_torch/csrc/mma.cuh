// Shared helpers for the hand-written Hopper kernels: bf16 packing, and the
// fp32 products of attention_f32.cu on the tensor cores (mma.sync m16n8k8 in
// TF32, three products per fp32 product: 3xTF32; gemm_f32.cuh runs the same
// split on wgmma).
//
// Fragment layouts of m16n8k8 in TF32, one fp32 register per element
// (g = lane / 4, t = lane % 4):
//   A (16x8, row-major), 4 regs: a0 = (row g, col t),   a1 = (row g+8, col t),
//                                 a2 = (row g, col t+4), a3 = (row g+8, col t+4)
//   B (8x8, k-major),    2 regs: b0 = (k t, col g),     b1 = (k t+4, col g)
//   C (16x8, fp32),      4 regs: c0,c1 = (row g, cols 2t, 2t+1), c2,c3 = (row g+8, ...)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pi3 {

// Two fp32 values rounded to bf16 (round to nearest even) as one register.
__device__ __forceinline__ uint32_t pack_float2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- cp.async: the fp32 kernels' loads into shared memory

// 16 bytes src -> dst (shared), or 16 zero bytes without reading src where
// !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- fp32 on the tensor cores: 3xTF32
//
// x = big + small with big = tf32(x) and small = tf32(x - big), both rounded
// to nearest; x.y is then big.big' + big.small' + small.big' up to the
// small.small' term and the rounding of small, ~2^-22 of |x.y| (TF32 alone
// keeps ~2^-11). The products are exact in the tensor cores, but an mma adds
// them to its accumulator with truncation, a bias that grows with the
// number of mma into one accumulator (measured on an H100: relative L2 3e-5
// against cuBLAS fp32 at K 1536). So each k-step's three products go into a
// zeroed accumulator of their own, which is then added to the running sum
// in fp32 with round to nearest: a 3xTF32 product with fp32's accuracy.

struct Tf32Pair {
  uint32_t big, small;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y & 0xffffe000u;  // the tf32 value as an fp32 bit pattern
}

__device__ __forceinline__ Tf32Pair split_tf32(float x) {
  const uint32_t big = to_tf32(x);
  return {big, to_tf32(x - __uint_as_float(big))};  // x - big is exact
}

__device__ __forceinline__ void mma_tf32_1688(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += A . B (one k-step of 8) in fp32 accuracy from split fragments: the
// small terms first, so the big product lands on a sum that holds them, all
// three in a zeroed accumulator that is then added to c in fp32.
__device__ __forceinline__ void mma_3xtf32(float c[4], const Tf32Pair (&a)[4],
                                           const Tf32Pair (&b)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_1688(t, a[0].small, a[1].small, a[2].small, a[3].small, b[0].big, b[1].big);
  mma_tf32_1688(t, a[0].big, a[1].big, a[2].big, a[3].big, b[0].small, b[1].small);
  mma_tf32_1688(t, a[0].big, a[1].big, a[2].big, a[3].big, b[0].big, b[1].big);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

}  // namespace pi3
