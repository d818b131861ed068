// The block MLP's GEMMs in float32 for Hopper (sm_90a): the fp32 entries of
// block_mlp.cu. out[M, N] = epilogue(A[M, K] . W[N, K]^T), A, W and out fp32
// (W in torch's nn.Linear layout), with gemm.cuh's three epilogues:
//   kGelu:     out = GELU_erf(acc + bias)
//   kResidual: out = resid + ls * (acc + bias)
//   kBias:     out = acc + bias
// all in fp32, as the JAX package's fp32 path computes them (its hidden
// activation stays fp32). No split-K and no atomics: two calls give the same
// bits.
//
// Design: the products on the tensor cores in TF32 with the 3xTF32 split
// (mma.cuh), which keeps fp32's accuracy. One 128 x 128 output tile a block
// of 8 warps (2 x 4, a warp 64 x 32: 4 x 4 m16n8k8 tiles, 64 accumulators a
// thread); a ring of 3 stages of 32-deep k steps (A and W 128 rows of 32
// floats each, 36 KB a stage) filled by cp.async 16-byte chunks; rows of A
// >= M are zero-filled and never read. Shared-memory rows are 36 floats, so
// every fragment load is bank-conflict free. The epilogue writes fp32 pairs
// from the accumulators, rows >= M not stored.
//
// Bound on the H100: operations, 2 M N K per product over 3xTF32's 165
// TFLOP/s (a third of TF32's 495). This first fp32 GEMM is written to be
// right: mma.sync from cp.async stages, not gemm.cuh's TMA + wgmma loop.
#pragma once

#include "gemm.cuh"

namespace pi3 {

constexpr int kF32Tile = 128;    // output tile: 128 x 128
constexpr int kF32BK = 32;       // k step: 32 floats (128 bytes) a row
constexpr int kF32Ld = kF32BK + 4;
constexpr int kF32Stages = 3;
constexpr int kF32Threads = 256;  // 8 warps, 2 (rows) x 4 (columns)
constexpr int kF32StageFloats = 2 * kF32Tile * kF32Ld;  // A then W
constexpr int kF32GemmSmemBytes = kF32Stages * kF32StageFloats * 4;
static_assert(kF32GemmSmemBytes <= 232448,
              "the fp32 GEMM's ring exceeds 227 KB of shared memory");

// k step kt's A (rows m0 .., zero past M) and W (rows n0 ..) -> stage.
__device__ __forceinline__ void gemm_f32_load(float* stage, const float* __restrict__ A,
                                              const float* __restrict__ W, int m0, int n0, int M,
                                              int K, int kt) {
  constexpr int kChunks = kF32BK / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < 2 * kF32Tile * kChunks; i += kF32Threads) {
    const int r = i / kChunks;  // rows 0..127 of A, then 128..255 of W
    const int c = (i % kChunks) * 4;
    const bool is_a = r < kF32Tile;
    const int row = is_a ? m0 + r : n0 + r - kF32Tile;
    const bool valid = !is_a || row < M;
    const float* src = (is_a ? A : W) + (size_t)(valid ? row : 0) * K + kt * kF32BK + c;
    cp_async16(stage + r * kF32Ld + c, src, valid);
  }
  cp_async_commit();
}

template <int EPI>
__global__ void __launch_bounds__(kF32Threads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* __restrict__ ls,
                const float* __restrict__ resid, float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * kF32Tile;
  const int n0 = blockIdx.x * kF32Tile;
  const int n_k = K / kF32BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 64;  // the warp's rows and columns within the tile
  const int wn = (warp & 3) * 32;

  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < n_k) gemm_f32_load(smem + s * kF32StageFloats, A, W, m0, n0, M, K, s);
    else cp_async_commit();
  }
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // step kt landed; step kt - 1's stage is free
    const int next = kt + kF32Stages - 1;
    if (next < n_k)
      gemm_f32_load(smem + (next % kF32Stages) * kF32StageFloats, A, W, m0, n0, M, K, next);
    else
      cp_async_commit();
    const float* sa = smem + (kt % kF32Stages) * kF32StageFloats + (wm + g) * kF32Ld;
    const float* sw = smem + (kt % kF32Stages) * kF32StageFloats + (kF32Tile + wn + g) * kF32Ld;
#pragma unroll
    for (int kk = 0; kk < kF32BK / 8; ++kk) {
      const int c = 8 * kk + t;
      Tf32Pair b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = split_tf32(sw[8 * j * kF32Ld + c]);
        b[j][1] = split_tf32(sw[8 * j * kF32Ld + c + 4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* ar = sa + 16 * i * kF32Ld + c;
        const Tf32Pair a[4] = {split_tf32(ar[0]), split_tf32(ar[8 * kF32Ld]), split_tf32(ar[4]),
                               split_tf32(ar[8 * kF32Ld + 4])};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_3xtf32(acc[i][j], a, b[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
    float2 sc = make_float2(1.f, 1.f);
    if constexpr (EPI == kResidual) sc = *reinterpret_cast<const float2*>(ls + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + 16 * i + g + 8 * half;
        if (row >= M) continue;
        float v0 = acc[i][j][2 * half] + bb.x;
        float v1 = acc[i][j][2 * half + 1] + bb.y;
        if constexpr (EPI == kGelu) {
          v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
          v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
        } else if constexpr (EPI == kResidual) {
          const float2 x = *reinterpret_cast<const float2*>(resid + (size_t)row * N + col);
          v0 = x.x + sc.x * v0;
          v1 = x.y + sc.y * v1;
        }
        *reinterpret_cast<float2*>(out + (size_t)row * N + col) = make_float2(v0, v1);
      }
    }
  }
}

// out (M, N) = epilogue(A (M, K) . W (N, K)^T) on stream; N and K multiples
// of 128 and 32, A and W 16-byte aligned. Returns a cudaError_t.
template <int EPI>
int launch_gemm_f32(const float* A, const float* W, const float* bias, const float* ls,
                    const float* resid, float* out, int M, int N, int K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_f32_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kF32GemmSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / kF32Tile, (M + kF32Tile - 1) / kF32Tile);
  gemm_f32_kernel<EPI><<<grid, kF32Threads, kF32GemmSmemBytes, stream>>>(A, W, bias, ls, resid,
                                                                        out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace pi3
