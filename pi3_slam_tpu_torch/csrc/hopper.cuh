// Hopper (sm_90a) building blocks of the TMA + wgmma kernels (packed_attention.cu;
// attention.cu and partial_attention.cu through bthd_attention.cuh; block_mlp.cu
// through gemm.cuh and gemm_f32.cuh; attention_f32.cu through
// bthd_attention_f32.cuh): bf16 packing, mbarriers, TMA tile loads and
// stores, wgmma shared-memory descriptors and products (bf16, and tf32 for
// the fp32 GEMM and attention), the 3xTF32 split, named barriers, exp2, the
// base-2 online softmax on the wgmma accumulator layout, and the driver's
// tensor-map encoder.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pi3 {

// Two fp32 values rounded to bf16 (round to nearest even) as one register.
__device__ __forceinline__ uint32_t pack_float2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait of more than
// ~2^34 clocks (seconds; every real wait is microseconds) traps, so that a
// barrier fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 0xFFFFu) == 0) {
      if (start == 0) start = clock64();
      else if (clock64() - start > (1ll << 34)) __trap();
    }
  }
}

// One box of a 2D tensor map at (col, row) -> dst, completion counted on bar
// in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// One box of shared memory -> a 2D tensor map at (col, row); elements past
// the map's extent are not written. Completion is tracked per bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N bulk groups still read their shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (a TMA store that reads them).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of a 3D tensor map at (col, row, batch) -> dst, completion counted
// on bar in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

// One box of a 4D (column, head, row, batch) tensor map -> dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// --- wgmma

// Shared-memory matrix descriptor of a tile as TMA's 128-byte swizzle lays
// it out: rows of 128 bytes (64 bf16 columns), 8-row groups 1024 bytes apart
// (stride byte offset), swizzle mode 1 (128B) in bits 62-63. The leading byte
// offset is the distance between 64-column boxes of an MN-major operand that
// is wider than 64 (its N spans several boxes); K-major operands and a
// 64-wide MN-major one do not read it (a k16 step, 32 bytes, lies inside one
// swizzled row).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t box_bytes = 16) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(box_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous product that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x N fp32) = [d +] A (64 x 16, smem) . B^T (N x 16, smem), both
// K-major; accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate);

// d (64 x N fp32) += A (64 x 16 bf16, registers) . B (16 x N, smem, MN-major:
// the transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b);

#define PI3_F8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24), PI3_F8(32)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24), PI3_F8(32), PI3_F8(40), PI3_F8(48), PI3_F8(56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24), PI3_F8(32), PI3_F8(40), PI3_F8(48), PI3_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24), PI3_F8(32), PI3_F8(40), PI3_F8(48), PI3_F8(56),
      PI3_F8(64), PI3_F8(72), PI3_F8(80), PI3_F8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24), PI3_F8(32), PI3_F8(40), PI3_F8(48), PI3_F8(56),
      PI3_F8(64), PI3_F8(72), PI3_F8(80), PI3_F8(88), PI3_F8(96), PI3_F8(104), PI3_F8(112), PI3_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x N fp32) = [d +] A (64 x 8, smem) . B^T (N x 8, smem) in TF32,
// both K-major fp32 tiles as TMA's 128-byte swizzle lays them out (rows of
// 32 floats; a k8 step is 32 bytes, the descriptor advance of bf16's k16).
// tf32 takes no transpose immediates. accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<128>(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24), PI3_F8(32), PI3_F8(40), PI3_F8(48), PI3_F8(56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x N fp32) = [d +] A (64 x 8 tf32, registers: the m16n8k8 layout per
// warp, a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4))
// . B^T (N x 8, smem, K-major). The registers may hold any fp32 pattern: the
// tensor cores read its top 19 bits.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24), PI3_F8(32), PI3_F8(40), PI3_F8(48), PI3_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      :
      PI3_F8(0), PI3_F8(8), PI3_F8(16), PI3_F8(24), PI3_F8(32), PI3_F8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#undef PI3_F8

// The small part of x's 3xTF32 split as the tensor cores will read it: big
// is x's raw pattern (the tensor cores read an fp32 pattern as TF32 by
// dropping its low 13 bits), small = x - big (exact), rounded to TF32 (to
// nearest, ties away: half a TF32 ulp added to the pattern, whose low bits
// the tensor cores then drop).
__device__ __forceinline__ float tf32_small(float x) {
  const float big = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __uint_as_float(__float_as_uint(x - big) + 0x1000u);
}

// Named barriers 1 and 2 order the two consumer warpgroups' products.
__device__ __forceinline__ void bar_sync(uint32_t id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
// A named barrier over one warpgroup (128 threads).
__device__ __forceinline__ void bar_sync_warpgroup(uint32_t id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- base-2 online softmax on the wgmma accumulators
//
// This thread's accumulator entries (any m64nN wgmma): rows r0 = 16 warp +
// lane/4 and r0 + 8 of the warpgroup's 64; entry 4i + e (e < 2) is row r0,
// column 8i + 2 t4 + e (t4 = lane % 4), entry 4i + 2 + e the same column of
// row r0 + 8. The four threads of a quad hold a row's columns.
struct Rows {
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw logits
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums
  float a0, a1;                          // rescale of O and l for the tile in flight
  float rs0, rs1;                        // its partial row sums
};

// Base-2 online softmax of one N-key tile's raw logits (keys k0 .. k0+N-1;
// keys >= t_valid masked): updates the running max and turns acc into
// 2^(scale * (s - m)); the rescale of O waits for the product in flight.
// Key k0 < t_valid is in every tile, so the max stays finite.
template <int N>
__device__ __forceinline__ void softmax_tile(Rows& r, float (&acc)[N / 2], int k0, int t_valid,
                                             int t4, float scale_log2) {
  if (k0 + N > t_valid) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + 8 * i + 2 * t4 + e >= t_valid) acc[4 * i + e] = acc[4 * i + 2 + e] = -INFINITY;
      }
    }
  }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(acc[4 * i], acc[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(acc[4 * i + 2], acc[4 * i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  r.a0 = ex2((r.m0 - mx0) * scale_log2);  // 0 on the first tile (m = -inf)
  r.a1 = ex2((r.m1 - mx1) * scale_log2);
  r.m0 = mx0;
  r.m1 = mx1;
  const float sub0 = mx0 * scale_log2;
  const float sub1 = mx1 * scale_log2;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    acc[4 * i] = ex2(fmaf(acc[4 * i], scale_log2, -sub0));
    acc[4 * i + 1] = ex2(fmaf(acc[4 * i + 1], scale_log2, -sub0));
    acc[4 * i + 2] = ex2(fmaf(acc[4 * i + 2], scale_log2, -sub1));
    acc[4 * i + 3] = ex2(fmaf(acc[4 * i + 3], scale_log2, -sub1));
    rs0 += acc[4 * i] + acc[4 * i + 1];
    rs1 += acc[4 * i + 2] + acc[4 * i + 3];
  }
  r.rs0 = rs0;
  r.rs1 = rs1;
}

// P = the accumulators rounded to bf16 (round to nearest even) as the A
// operand of the P V product (keys 16kk .. 16kk+15 are accumulator columns
// 2kk, 2kk+1: the A-operand layout of k-step kk).
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    p[kk][0] = pack_float2(acc[8 * kk], acc[8 * kk + 1]);
    p[kk][1] = pack_float2(acc[8 * kk + 2], acc[8 * kk + 3]);
    p[kk][2] = pack_float2(acc[8 * kk + 4], acc[8 * kk + 5]);
    p[kk][3] = pack_float2(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// After the product in flight has finished: rescale O (64 x D) and the row
// sums, and round P to bf16.
template <int N, int D>
__device__ __forceinline__ void finish_tile(Rows& r, float (&o)[D / 2], uint32_t (&p)[N / 16][4],
                                            const float (&acc)[N / 2]) {
  r.l0 = r.l0 * r.a0 + r.rs0;
  r.l1 = r.l1 * r.a1 + r.rs1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[4 * n] *= r.a0;
    o[4 * n + 1] *= r.a0;
    o[4 * n + 2] *= r.a1;
    o[4 * n + 3] *= r.a1;
  }
  pack_p<N>(p, acc);
}

// --- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace pi3
