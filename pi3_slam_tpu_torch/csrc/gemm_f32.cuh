// The block MLP's GEMMs in float32 for Hopper (sm_90a): the fp32 entries of
// block_mlp.cu. out[M, N] = epilogue(A[M, K] . W[N, K]^T), A, W and out fp32
// (W in torch's nn.Linear layout: both operands K-major, as wgmma's tf32
// form requires), with gemm.cuh's three epilogues:
//   kGelu:     out = GELU_erf(acc + bias)
//   kResidual: out = resid + ls * (acc + bias)
//   kBias:     out = acc + bias
// all in fp32, as the JAX package's fp32 path computes them (its hidden
// activation stays fp32). No split-K and no atomics: two calls give the same
// bits.
//
// Design: gemm.cuh's loop (a TMA producer, an mbarrier ring, consumer
// warpgroups on wgmma, the epilogue staged in the freed ring and written by
// TMA stores) with the products in TF32 and the 3xTF32 split, which keeps
// fp32's accuracy (TF32 alone keeps ~3 digits):
// * Tiles. One 128 x 128 output tile per block (grid: N tiles x M tiles, N
//   fastest), 384 threads: a producer warpgroup and two consumer
//   warpgroups of 64 rows each (64 x 128: a running fp32 sum and a wgmma
//   accumulator, 128 registers a thread), one block per SM.
// * Loads. 2D tensor maps with 128-byte swizzle, boxes of 32 columns (one
//   128-byte row of fp32) x 128 rows: a k step is 32 deep, four k8 steps of
//   32 bytes each (the descriptor advance of bf16's k16). A's row extent is
//   M, so rows >= M come in zero-filled and no row behind M is read. One
//   producer thread keeps a ring of 4 stages (A and W 128 x 32, 32 KB) full.
// * The split, once per element. x = big + small with big = x's top 19 bits
//   (the tensor cores read an fp32 pattern as TF32 by dropping its low 13
//   bits: PERF.md's probe), so the raw fp32 value is big; small = x - big
//   (exact), rounded to TF32 (to nearest, ties away: half a TF32 ulp added
//   to the pattern, whose low bits the tensor cores then drop). W: the
//   producer warpgroup's other three warps write each landed stage's small
//   parts into a ring beside it and arrive on the stage's ready barrier
//   (after a proxy fence: the tensor cores read them through the async
//   proxy). A: each consumer thread loads its fragments of the stage (the
//   wgmma A-register layout, 16 floats a stage) and splits them in
//   registers.
// * Products. Per k8 step a consumer warpgroup issues three wgmma
//   m64n128k8 tf32 on one accumulator, small.big', big.small', big.big' (the
//   small terms first), A from registers and W from shared memory: ~176 KB
//   of shared-memory traffic a stage against ~240 with both operands there
//   (that form ran 104 against 120 TFLOP/s on an H100, PERF.md). The tensor
//   cores truncate when they accumulate, a bias that grows with the number
//   of products in one accumulator (2.9e-5 relative L2 over K 4096 in one
//   accumulator, PERF.md), so kF32GroupK8 k8 steps go into one accumulator
//   group (scale-d 0 on its first product), which is then added to the
//   running sum in fp32 with round to nearest. Each stage waits for its products
//   before its A registers are reloaded, and the other warpgroup's products
//   fill the tensor cores meanwhile.
// * Epilogue. Once both warpgroups' products are done the ring is free:
//   bias (+ GELU, or x ls + residual) on the sums, fp32 into the ring laid
//   out as the output map's boxes (32 columns x 64 rows, swizzled), then TMA
//   stores, which clip rows >= M.
//
// Bound on the H100: operations, 2 M N K per product over 3xTF32's 165
// TFLOP/s (a third of TF32's 495): 3.27 ms a product at the global shape
// (64300 x 1024, hidden 4096).
#pragma once

#include "gemm.cuh"

namespace pi3 {

constexpr int kF32Threads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kF32Rows = 64;      // a consumer warpgroup's rows of the tile
constexpr int kF32Tile = 128;     // output tile: 128 x 128
constexpr int kF32BK = 32;        // k step: one 128-byte swizzled row of fp32
constexpr int kF32Stages = 4;
constexpr int kF32GroupK8 = 4;    // k8 steps summed in one wgmma accumulator (PERF.md)
constexpr int kF32SplitThreads = 96;  // the producer warpgroup's warps 1-3
constexpr int kF32TileFloats = kF32Tile * kF32BK;

struct __align__(1024) GemmF32Smem {
  float a[kF32Stages][kF32TileFloats];  // the TMA ring: A's and W's raw (big) tiles
  float b[kF32Stages][kF32TileFloats];
  float b_small[kF32Stages][kF32TileFloats];  // W's small parts, same layout
  uint64_t full[kF32Stages];   // the stage's tiles landed
  uint64_t ready[kF32Stages];  // its small parts written
  uint64_t empty[kF32Stages];  // its products done
};

constexpr int kF32GemmSmemBytes = sizeof(GemmF32Smem) + 1024;  // + slack to align the base
static_assert(kF32GemmSmemBytes <= 232448, "the fp32 GEMM's rings exceed 227 KB of shared memory");

// Warps 1-3 of the producer warpgroup: each landed stage's small parts of W.
__device__ __forceinline__ void gemm_f32_split(GemmF32Smem& sm, int kt, int sid, int lane) {
  for (int k = 0; k < kt; ++k) {
    const int s = k % kF32Stages;
    mbar_wait(&sm.full[s], (k / kF32Stages) & 1);
    const float4* b = reinterpret_cast<const float4*>(sm.b[s]);
    float4* bs = reinterpret_cast<float4*>(sm.b_small[s]);
    for (int i = sid; i < kF32TileFloats / 4; i += kF32SplitThreads) {
      const float4 y = b[i];
      bs[i] = make_float4(tf32_small(y.x), tf32_small(y.y), tf32_small(y.z), tf32_small(y.w));
    }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.ready[s]);
  }
}

// One consumer warpgroup's 64 rows (a_off: their offset in A's tile) over kt
// k steps into sum; G k8 steps (a multiple of a stage's 4) a group.
template <int G>
__device__ __forceinline__ void gemm_f32_mainloop(float (&sum)[64], GemmF32Smem& sm, int a_off,
                                                  int kt, int warp, int lane) {
  static_assert(G % (kF32BK / 8) == 0, "a group is whole stages");
  constexpr int kGroupStages = G / (kF32BK / 8);
  // this thread's A fragment of k8 step kk: rows r and r + 8 (r % 8 = g),
  // columns 8kk + t and 8kk + t + 4, i.e. 16-byte chunks 2kk and 2kk + 1 of
  // the swizzled rows (chunk j of row r at j ^ (r % 8))
  const int g = lane >> 2;
  const int row = (16 * warp + g) * 128 + (lane & 3) * 4;  // bytes
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.f;
  for (int k = 0; k < kt; ++k) {
    const int s = k % kF32Stages;
    const uint32_t phase = (k / kF32Stages) & 1;
    mbar_wait(&sm.full[s], phase);
    const uint8_t* a = reinterpret_cast<const uint8_t*>(sm.a[s] + a_off) + row;
    uint32_t big[kF32BK / 8][4], small[kF32BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kF32BK / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = *reinterpret_cast<const float*>(
            a + (e & 1) * 8 * 128 + (((2 * kk + (e >> 1)) ^ g) << 4));
        big[kk][e] = __float_as_uint(x);
        small[kk][e] = __float_as_uint(tf32_small(x));
      }
    }
    mbar_wait(&sm.ready[s], phase);
    const bool first = k % kGroupStages == 0;
    const uint64_t bb = smem_desc(sm.b[s]);
    const uint64_t bs = smem_desc(sm.b_small[s]);
    fence_regs(acc);
    fence_regs(big);
    fence_regs(small);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kF32BK / 8; ++kk) {  // 32 bytes a k8 step
      wgmma_tf32_rs<128>(acc, small[kk], bb + 2 * kk, (first && kk == 0) ? 0 : 1);
      wgmma_tf32_rs<128>(acc, big[kk], bs + 2 * kk, 1);
      wgmma_tf32_rs<128>(acc, big[kk], bb + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();  // the stage's products are done: its A registers and ring slot are free
    fence_regs(acc);
    fence_regs(big);
    fence_regs(small);
    if (lane == 0) mbar_arrive(&sm.empty[s]);
    if ((k + 1) % kGroupStages == 0 || k + 1 == kt) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
  }
}

// The epilogue of one warpgroup's 64 x 128 (rows m0 ..; sum in the wgmma
// layout of hopper.cuh's Rows) into its staging: box i / 4 (32 columns x 64
// rows), 16-byte chunk j of row r at chunk j ^ (r % 8).
template <int EPI>
__device__ __forceinline__ void gemm_f32_epilogue(const float (&sum)[64], float* staging, int m0,
                                                  int n0, int M, int N,
                                                  const float* __restrict__ bias,
                                                  const float* __restrict__ ls,
                                                  const float* __restrict__ resid, int warp,
                                                  int lane) {
  const int g = lane >> 2;
  const int t4 = lane & 3;
  uint8_t* base = reinterpret_cast<uint8_t*>(staging);
#pragma unroll
  for (int i = 0; i < kF32Tile / 8; ++i) {
    const int col = n0 + 8 * i + 2 * t4;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
    float2 sc = make_float2(1.f, 1.f);
    if constexpr (EPI == kResidual) sc = *reinterpret_cast<const float2*>(ls + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half;
      float v0 = sum[4 * i + 2 * half] + bb.x;
      float v1 = sum[4 * i + 2 * half + 1] + bb.y;
      if constexpr (EPI == kGelu) {
        v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
        v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
      } else if constexpr (EPI == kResidual) {
        float2 x = make_float2(0.f, 0.f);
        if (m0 + r < M) x = *reinterpret_cast<const float2*>(resid + (size_t)(m0 + r) * N + col);
        v0 = x.x + sc.x * v0;
        v1 = x.y + sc.y * v1;
      }
      *reinterpret_cast<float2*>(base + (i >> 2) * (kF32Rows * 128) + r * 128 +
                                 (((2 * (i & 3) + (t4 >> 1)) ^ (r & 7)) << 4) + (t4 & 1) * 8) =
          make_float2(v0, v1);
    }
  }
}

// One 128 x 128 tile per block (the design in the header); G: k8 steps a
// group.
template <int EPI, int G>
__global__ void __launch_bounds__(kF32Threads, 1)
gemm_f32_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap b_map,
                const __grid_constant__ CUtensorMap out_map, const float* __restrict__ bias,
                const float* __restrict__ ls, const float* __restrict__ resid, int M, int N,
                int K) {
  extern __shared__ __align__(128) uint8_t smem_raw[];  // aligned to 1024 below
  const uint32_t raw = smem_u32(smem_raw);
  GemmF32Smem& sm = *reinterpret_cast<GemmF32Smem*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));

  const int m0 = blockIdx.y * kF32Tile;
  const int n0 = blockIdx.x * kF32Tile;
  const int kt = K / kF32BK;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.ready[s], kF32SplitThreads / 32);  // one arrival per split warp
      mbar_init(&sm.empty[s], 8);                       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer warpgroup: warp 0 loads, warps 1-3 split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int k = 0; k < kt; ++k) {
        const int s = k % kF32Stages;
        mbar_wait(&sm.empty[s], ((k / kF32Stages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(&sm.full[s], 2 * kF32TileFloats * 4);
        tma_load(sm.a[s], &a_map, &sm.full[s], k * kF32BK, m0);
        tma_load(sm.b[s], &b_map, &sm.full[s], k * kF32BK, n0);
      }
    } else if (threadIdx.x >= 32) {
      gemm_f32_split(sm, kt, threadIdx.x - 32, lane);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;  // consumer warpgroup: rows m0 + 64c .. m0 + 64c + 63
  const int tid = threadIdx.x - 128 * wg;
  float sum[64];
  gemm_f32_mainloop<G>(sum, sm, c * kF32Rows * kF32BK, kt, tid >> 5, lane);
  bar_sync(1);  // both warpgroups' products done: the rings are free
  const int mc = m0 + c * kF32Rows;
  float* staging = sm.a[2 * c];  // two stages of A: the four boxes of 64 x 128
  gemm_f32_epilogue<EPI>(sum, staging, mc, n0, M, N, bias, ls, resid, tid >> 5, lane);
  fence_async_smem();
  bar_sync_warpgroup(3 + c);
  if (tid == 0 && mc < M) {
#pragma unroll
    for (int b = 0; b < kF32Tile / 32; ++b)
      tma_store(&out_map, staging + b * kF32Rows * 32, n0 + 32 * b, mc);
    bulk_commit();
    bulk_wait_read<0>();  // shared memory stays valid until the stores have read it
  }
}

// out (M, N) = epilogue(A (M, K) . W (N, K)^T) on stream; N and K multiples
// of 128 and 32, A, W and out 16-byte aligned. Returns a cudaError_t;
// cudaErrorInvalidValue if a map cannot be encoded.
template <int EPI, int G = kF32GroupK8>
int launch_gemm_f32(const float* A, const float* W, const float* bias, const float* ls,
                    const float* resid, float* out, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap a_map, b_map, out_map;
  if (!encode_matrix_map(&a_map, A, M, K, kF32Tile, 4) ||
      !encode_matrix_map(&b_map, W, N, K, kF32Tile, 4) ||
      !encode_matrix_map(&out_map, out, M, N, kF32Rows, 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_f32_kernel<EPI, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kF32GemmSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / kF32Tile, (M + kF32Tile - 1) / kF32Tile);
  gemm_f32_kernel<EPI, G><<<grid, kF32Threads, kF32GemmSmemBytes, stream>>>(
      a_map, b_map, out_map, bias, ls, resid, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace pi3
