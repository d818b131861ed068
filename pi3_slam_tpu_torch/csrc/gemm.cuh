// The block MLP's GEMMs for Hopper (sm_90a), TMA + wgmma with the epilogue
// fused: out[M, N] = epilogue(A[M, K] . W[N, K]^T), A and W bf16 and both
// K-major (W in torch's nn.Linear layout, a "TN" product), fp32 accumulators,
// bf16 out:
//   kGelu:     out = bf16(GELU_erf(acc + bias))
//   kResidual: out = bf16(resid + ls * (acc + bias))
//   kBias:     out = bf16(acc + bias)
// bias, ls and the residual sum stay fp32; no split-K and no atomics, so two
// calls give the same bits.
//
// * Tiles. One 256 x 128 output tile per block (grid: N tiles x M tiles, N
//   fastest, so the blocks in flight share A's rows and W stays in L2), 384
//   threads: a producer warpgroup and two consumer warpgroups of 128 rows
//   each, one block per SM.
// * Loads. One 2D tensor map per operand (columns K, rows M or N), 128-byte
//   swizzle, boxes of 64 columns (one 128-byte row of bf16): a k step is 64
//   deep. A's row extent is M, so rows >= M come in zero-filled and no row
//   behind M is ever read. One producer thread keeps a ring of 4 stages (A
//   256 x 64 and W 128 x 64, 48 KB) full, each with a full and an empty
//   mbarrier.
// * Products. Per k16 step a consumer warpgroup issues two wgmma m64n128k16
//   (its rows 0-63 and 64-127) on one W descriptor, both operands from the
//   swizzled stage, 32 bytes apart per k16 step (a 64-deep step lies inside
//   one swizzled row, so the leading byte offset is unread); 128 fp32
//   accumulators a thread. Step k's products are issued before step k-1's
//   are waited for, and then step k-1's stage is released.
// * Epilogue. Once both warpgroups' products are done the ring is free: bias
//   (+ GELU, or x ls + residual) on the accumulators, bf16 into A's first two
//   stages laid out as the output map's boxes (64 columns x 128 rows,
//   swizzled: conflict-free stores from the wgmma layout), then TMA stores,
//   which clip rows >= M.
//
// A persistent variant (one block per SM walking 128 x 128 tiles, the two
// consumer warpgroups taking turns so that each epilogue ran under the
// other's products) was measured against this one on an H100 and was no
// faster (PERF.md §6): a 128 x 128 tile loads a third more bytes per
// product than 256 x 128.
//
// Bound on the H100: operations. At the global shape (64300 x 1024, hidden
// 4096) each product is 0.54 TFLOP against ~0.7 GB of traffic, far above
// the ~295 flop/byte ridge.
#pragma once

#include "hopper.cuh"

namespace pi3 {

enum GemmEpilogue { kGelu = 0, kResidual = 1, kBias = 2 };

constexpr int kGemmThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kGemmTile = 128;     // a consumer warpgroup's output tile: 128 x 128
constexpr int kGemmBK = 64;        // k step: one 128-byte swizzled row of bf16
constexpr int kGemmStages = 4;

struct __align__(1024) GemmSmem {
  __nv_bfloat16 a[kGemmStages][2 * kGemmTile * kGemmBK];
  __nv_bfloat16 b[kGemmStages][kGemmTile * kGemmBK];
  uint64_t full[kGemmStages];
  uint64_t empty[kGemmStages];
};

constexpr int kGemmSmemBytes = sizeof(GemmSmem) + 1024;  // + slack to align the dynamic base
static_assert(kGemmSmemBytes <= 232448, "the GEMM's ring exceeds 227 KB of shared memory");

// acc0 / acc1 [+]= rows 0-63 / 64-127 of a (128 rows of the stage's A box)
// . b (128 rows of W's box)^T over one 64-deep k step; first: overwrite.
__device__ __forceinline__ void gemm_issue(float (&acc0)[64], float (&acc1)[64],
                                           const __nv_bfloat16* a, const __nv_bfloat16* b,
                                           bool first) {
  const uint64_t a0 = smem_desc(a);
  const uint64_t a1 = smem_desc(a + 64 * kGemmBK);
  const uint64_t bd = smem_desc(b);
#pragma unroll
  for (int kk = 0; kk < kGemmBK / 16; ++kk) {
    const int accumulate = (first && kk == 0) ? 0 : 1;
    wgmma_ss<128>(acc0, a0 + 2 * kk, bd + 2 * kk, accumulate);  // 32 bytes a k16 step
    wgmma_ss<128>(acc1, a1 + 2 * kk, bd + 2 * kk, accumulate);
  }
  wgmma_commit();
}

// One warpgroup's 128 rows over kt k steps (stage k % S, phase (k / S) & 1;
// a: its rows of stage 0's A box). A stage is released (one arrival per
// warp) once the products that read it have finished.
__device__ __forceinline__ void gemm_mainloop(float (&acc0)[64], float (&acc1)[64], GemmSmem& sm,
                                              const __nv_bfloat16* a, int kt, int lane) {
  for (int k = 0; k < kt; ++k) {
    const int s = k % kGemmStages;
    mbar_wait(&sm.full[s], (k / kGemmStages) & 1);
    fence_regs(acc0);
    fence_regs(acc1);
    wgmma_fence();
    gemm_issue(acc0, acc1, a + s * (2 * kGemmTile * kGemmBK), sm.b[s], k == 0);
    if (k > 0) {
      wgmma_wait<1>();  // step k-1's products are done: its stage may be refilled
      if (lane == 0) mbar_arrive(&sm.empty[(k - 1) % kGemmStages]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  if (lane == 0) mbar_arrive(&sm.empty[(kt - 1) % kGemmStages]);
}

// The epilogue of one 64-row half of a tile (acc: tile rows row0 .. row0 +
// 63, the wgmma layout of hopper.cuh's Rows) into the staging tile: box
// i / 8 (64 columns), 16-byte chunk i % 8 of row r at chunk (i % 8) ^ (r % 8).
template <int EPI>
__device__ __forceinline__ void gemm_epilogue(const float (&acc)[64], __nv_bfloat16* staging,
                                              int row0, int m0, int n0, int M, int N,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ ls,
                                              const __nv_bfloat16* __restrict__ resid, int warp,
                                              int lane) {
  const int g = lane >> 2;
  const int t4 = lane & 3;
  uint8_t* base = reinterpret_cast<uint8_t*>(staging);
#pragma unroll
  for (int i = 0; i < kGemmTile / 8; ++i) {
    const int col = n0 + 8 * i + 2 * t4;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
    float2 sc = make_float2(1.f, 1.f);
    if constexpr (EPI == kResidual) sc = *reinterpret_cast<const float2*>(ls + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 16 * warp + g + 8 * half;
      float v0 = acc[4 * i + 2 * half] + bb.x;
      float v1 = acc[4 * i + 2 * half + 1] + bb.y;
      if constexpr (EPI == kGelu) {
        v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
        v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
      } else if constexpr (EPI == kResidual) {
        float x0 = 0.f, x1 = 0.f;
        if (m0 + r < M) {
          const __nv_bfloat162 x =
              *reinterpret_cast<const __nv_bfloat162*>(resid + (size_t)(m0 + r) * N + col);
          x0 = __bfloat162float(x.x);
          x1 = __bfloat162float(x.y);
        }
        v0 = x0 + sc.x * v0;
        v1 = x1 + sc.y * v1;
      }
      *reinterpret_cast<uint32_t*>(base + (i >> 3) * (kGemmTile * 128) + r * 128 +
                                   (((i & 7) ^ (r & 7)) << 4) + t4 * 4) = pack_float2(v0, v1);
    }
  }
}

// Staged tile -> out (two boxes of 64 columns x 128 rows), one bulk group.
__device__ __forceinline__ void gemm_store(const CUtensorMap* out_map,
                                           const __nv_bfloat16* staging, int m0, int n0) {
  tma_store(out_map, staging, n0, m0);
  tma_store(out_map, staging + kGemmTile * 64, n0 + 64, m0);
  bulk_commit();
}

// One 256 x 128 tile per block (the design in the header).
template <int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
            const __grid_constant__ CUtensorMap out_map, const float* __restrict__ bias,
            const float* __restrict__ ls, const __nv_bfloat16* __restrict__ resid, int M, int N,
            int K) {
  extern __shared__ __align__(128) uint8_t smem_raw[];  // aligned to 1024 below
  const uint32_t raw = smem_u32(smem_raw);
  GemmSmem& sm = *reinterpret_cast<GemmSmem*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));

  const int m0 = blockIdx.y * 2 * kGemmTile;
  const int n0 = blockIdx.x * kGemmTile;
  const int kt = K / kGemmBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      for (int k = 0; k < kt; ++k) {
        const int s = k % kGemmStages;
        mbar_wait(&sm.empty[s], ((k / kGemmStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(&sm.full[s], 3 * kGemmTile * kGemmBK * 2);
        tma_load(sm.a[s], &a_map, &sm.full[s], k * kGemmBK, m0);
        tma_load(sm.b[s], &b_map, &sm.full[s], k * kGemmBK, n0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;  // consumer warpgroup: rows m0 + 128c .. m0 + 128c + 127
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float acc0[64], acc1[64];
  gemm_mainloop(acc0, acc1, sm, sm.a[0] + c * kGemmTile * kGemmBK, kt, lane);
  bar_sync(1);  // both warpgroups' products done: the ring is free
  const int mc = m0 + c * kGemmTile;
  __nv_bfloat16* staging = sm.a[c];  // 256 x 64 bf16: the two boxes of a 128 x 128 tile
  gemm_epilogue<EPI>(acc0, staging, 0, mc, n0, M, N, bias, ls, resid, warp, lane);
  gemm_epilogue<EPI>(acc1, staging, 64, mc, n0, M, N, bias, ls, resid, warp, lane);
  fence_async_smem();
  bar_sync_warpgroup(3 + c);
  if (tid == 0 && mc < M) {
    gemm_store(&out_map, staging, mc, n0);
    bulk_wait_read<0>();  // shared memory stays valid until the stores have read it
  }
}

// The tensor map of a row-major (rows, cols) bf16 matrix (or fp32 where
// elem_bytes is 4; base 16-byte aligned, rows a multiple of 16 bytes): boxes
// of one 128-byte row (64 bf16 or 32 fp32 columns) x box_rows, 128-byte
// swizzle; rows >= rows load as zeros and are not stored.
inline bool encode_matrix_map(CUtensorMap* map, const void* base, int rows, int cols,
                              int box_rows, int elem_bytes = 2) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapDataType type =
      elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// out (M, N) = epilogue(A (M, K) . W (N, K)^T) on stream; N and K multiples
// of 128 and 64. Returns a cudaError_t; cudaErrorInvalidValue if a map
// cannot be encoded (a base the TMA does not take).
template <int EPI>
int launch_gemm(const __nv_bfloat16* A, const __nv_bfloat16* W, const float* bias,
                const float* ls, const __nv_bfloat16* resid, __nv_bfloat16* out, int M, int N,
                int K, cudaStream_t stream) {
  CUtensorMap a_map, b_map, out_map;
  if (!encode_matrix_map(&a_map, A, M, K, 2 * kGemmTile) ||
      !encode_matrix_map(&b_map, W, N, K, kGemmTile) ||
      !encode_matrix_map(&out_map, out, M, N, kGemmTile))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kGemmSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / kGemmTile, (M + 2 * kGemmTile - 1) / (2 * kGemmTile));
  gemm_kernel<EPI><<<grid, kGemmThreads, kGemmSmemBytes, stream>>>(a_map, b_map, out_map, bias,
                                                                   ls, resid, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace pi3
