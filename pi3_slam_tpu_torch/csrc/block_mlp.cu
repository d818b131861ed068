// Pre-norm block MLP half for Hopper (sm_90a):
//   out = x + ls * (fc2(GELU_erf(fc1(LN(x)))))
// and the bare MLP out = fc2(GELU_erf(fc1(x))).
//
// Replaces the Pallas TPU kernels of pi3_slam_tpu/ops/pallas_mlp.py:
//   block_mlp_fused_tpu (_block_mlp_body via _block_mlp_kernel3 /
//                        _block_mlp_kernel): entry pi3_block_mlp;
//   mlp_fused_tpu       (_mlp_core via _mlp_kernel3 / _mlp_kernel): entry
//                        pi3_mlp, the same two GEMMs without the LayerNorm
//                        pass and with a bias-only fc2 epilogue.
// Same numerics: LayerNorm statistics in fp32, the normalised row cast back
// to bf16 before fc1; fc1 and fc2 accumulate in fp32; bias + exact-erf GELU
// in fp32, cast to bf16 before fc2; bias, layer scale and the residual added
// in fp32.
//
// Bound on the H100: FLOPs. At the global shape (64300 x 1024, hidden 4096)
// the two products are 1.08 TFLOP against ~1.3 GB of traffic, well above
// the ~295 flop/byte ridge. The TPU kernel kept the (rows, 4096) hidden tile
// in VMEM; a 64-row x 1024 fp32 output tile does not fit one block's
// registers, so this first version runs three launches from one source:
//   1. layernorm_kernel: x -> LN(x) in bf16, one warp per row;
//   2. gemm_kernel<kGelu>: hidden = GELU(xn W1^T + b1) in bf16;
//   3. gemm_kernel<kResidual>: out = x + ls * (hidden W2^T + b2).
// pi3_mlp runs 2. on x itself and then gemm_kernel<kBias>: out = hidden
// W2^T + b2 (two launches). The hidden round trip costs ~1.05 GB per call (~0.3 ms at 3.35 TB/s);
// fusing it away is later work. The GEMMs are hand-written: 128x128 block
// tiles, 32-deep k steps double-buffered in shared memory with cp.async,
// 8 warps of 64x32 each on mma.sync m16n8k16 (bf16 in, fp32 accumulate).
// Weights are torch nn.Linear layout (out, in), so both operands are
// k-contiguous ("TN" GEMM) and every fragment is a 32-bit shared load.

#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLdk = kBK + 8;  // padded smem row (bf16): 80 bytes, conflict-free fragments
constexpr int kGemmThreads = 256;

enum Epilogue { kGelu = 0, kResidual = 1, kBias = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(256)
layernorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, __nv_bfloat16* __restrict__ y, int M, int C,
                 float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const __nv_bfloat16* xr = x + (size_t)row * C;
  float sum = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += __bfloat162float(v[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / C;
  float sq = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(v[i]) - mean;
      sq += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / C + eps);
  __nv_bfloat16* yr = y + (size_t)row * C;
  for (int c = lane * 8; c < C; c += 256) {
    uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
    uint4 packed;
    uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float y0 = (__bfloat162float(v[2 * i]) - mean) * rstd * gamma[c + 2 * i] + beta[c + 2 * i];
      const float y1 =
          (__bfloat162float(v[2 * i + 1]) - mean) * rstd * gamma[c + 2 * i + 1] + beta[c + 2 * i + 1];
      p[i] = pi3::pack_float2(y0, y1);
    }
    *reinterpret_cast<uint4*>(yr + c) = packed;
  }
}

// C[M, N] = A[M, K] . W[N, K]^T with a fused epilogue.
//   kGelu:     out = bf16(GELU_erf(acc + bias))
//   kResidual: out = bf16(resid + ls * (acc + bias))
//   kBias:     out = bf16(acc + bias)
// Requires N % 128 == 0 and K % 32 == 0; rows >= M are masked.
template <int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
            const float* __restrict__ bias, const float* __restrict__ ls,
            const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out, int M, int N,
            int K) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM][kLdk];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBN][kLdk];

  const int bm = blockIdx.y * kBM;
  const int bn = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = (warp >> 2) * 64;  // 2 x 4 warp grid, 64 x 32 per warp
  const int wn = (warp & 3) * 32;

  auto load_stage = [&](int stage, int k0) {
    // 128 rows x 4 chunks of 16 bytes for each operand: 2 chunks per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * kGemmThreads;
      const int r = idx >> 2;
      const int c = (idx & 3) * 8;
      const int ar = bm + r;
      const bool ok = ar < M;
      cp_async16(&As[stage][r][c], A + (size_t)(ok ? ar : 0) * K + k0 + c, ok);
      cp_async16(&Bs[stage][r][c], W + (size_t)(bn + r) * K + k0 + c, true);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int kt_total = K / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_total; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < kt_total) {
      load_stage(stage ^ 1, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int c = ks * 16 + 2 * t4;
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = pi3::ld_pair(&As[stage][r][c]);
        af[mi][1] = pi3::ld_pair(&As[stage][r + 8][c]);
        af[mi][2] = pi3::ld_pair(&As[stage][r][c + 8]);
        af[mi][3] = pi3::ld_pair(&As[stage][r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        const uint32_t b0 = pi3::ld_pair(&Bs[stage][n][c]);
        const uint32_t b1 = pi3::ld_pair(&Bs[stage][n][c + 8]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) pi3::mma_bf16_16816(acc[mi][ni], af[mi], b0, b1);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = bn + wn + ni * 8 + 2 * t4;
      const float bias0 = bias[col];
      const float bias1 = bias[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = bm + wm + mi * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = acc[mi][ni][2 * half] + bias0;
        float v1 = acc[mi][ni][2 * half + 1] + bias1;
        const size_t off = (size_t)row * N + col;
        if (EPI == kGelu) {
          v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
          v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
        } else if (EPI == kResidual) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(resid + off);
          v0 = __bfloat162float(r.x) + ls[col] * v0;
          v1 = __bfloat162float(r.y) + ls[col + 1] * v1;
        }
        *reinterpret_cast<uint32_t*>(out + off) = pi3::pack_float2(v0, v1);
      }
    }
  }
}

}  // namespace

// x: (M, C) bf16; gamma, beta, b2, ls: (C,) fp32; w1: (hidden, C) bf16;
// b1: (hidden,) fp32; w2: (C, hidden) bf16; xn: (M, C) and hid: (M, hidden)
// bf16 scratch; out: (M, C) bf16. C and hidden must be multiples of 128.
extern "C" int pi3_block_mlp(const void* x, const void* gamma, const void* beta, const void* w1,
                             const void* b1, const void* w2, const void* b2, const void* ls,
                             void* xn, void* hid, void* out, int M, int C, int hidden, float eps,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* xnb = static_cast<__nv_bfloat16*>(xn);
  auto* hb = static_cast<__nv_bfloat16*>(hid);
  layernorm_kernel<<<(M + 7) / 8, 256, 0, s>>>(xb, static_cast<const float*>(gamma),
                                               static_cast<const float*>(beta), xnb, M, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int mtiles = (M + kBM - 1) / kBM;
  gemm_kernel<kGelu><<<dim3(hidden / kBN, mtiles), kGemmThreads, 0, s>>>(
      xnb, static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1), nullptr, nullptr,
      hb, M, hidden, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gemm_kernel<kResidual><<<dim3(C / kBN, mtiles), kGemmThreads, 0, s>>>(
      hb, static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ls), xb, static_cast<__nv_bfloat16*>(out), M, C, hidden);
  return (int)cudaGetLastError();
}

// x: (M, C) bf16; w1: (hidden, C) bf16; b1: (hidden,) fp32; w2: (C, hidden)
// bf16; b2: (C,) fp32; hid: (M, hidden) bf16 scratch; out: (M, C) bf16.
// C and hidden must be multiples of 128.
extern "C" int pi3_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* hid, void* out, int M, int C, int hidden, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  auto* hb = static_cast<__nv_bfloat16*>(hid);
  const int mtiles = (M + kBM - 1) / kBM;
  gemm_kernel<kGelu><<<dim3(hidden / kBN, mtiles), kGemmThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), nullptr, nullptr, hb, M, hidden, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gemm_kernel<kBias><<<dim3(C / kBN, mtiles), kGemmThreads, 0, s>>>(
      hb, static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2), nullptr, nullptr,
      static_cast<__nv_bfloat16*>(out), M, C, hidden);
  return (int)cudaGetLastError();
}
