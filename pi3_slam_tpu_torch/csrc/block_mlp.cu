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
// in VMEM; a 128-row x 4096 hidden tile does not fit one SM's shared memory
// beside a pipelined fc2, so pi3_block_mlp runs three launches:
//   1. layernorm_kernel: x -> LN(x) in bf16, one warp per row (bytes-bound;
//      fc1 needs a row's statistics before its first k step);
//   2. the GEMM of gemm.cuh with the kGelu epilogue: hidden = GELU(xn W1^T + b1);
//   3. the GEMM with the kResidual epilogue: out = x + ls * (hidden W2^T + b2).
// pi3_mlp runs 2. on x itself and then the GEMM with the kBias epilogue:
// out = hidden W2^T + b2 (two launches). The hidden round trip costs ~1.05
// GB per call (~0.3 ms at 3.35 TB/s). The GEMMs are TMA + wgmma loops
// (gemm.cuh's header has the design).
//
// pi3_block_mlp_f32 and pi3_mlp_f32 are the fp32 entries (an fp32 model's
// blocks, as the JAX package runs the same Pallas kernels on fp32 input):
// the same launches with the LayerNorm pass in fp32 out and the GEMMs of
// gemm_f32.cuh (TMA + wgmma in TF32 with the 3xTF32 split), fp32 throughout
// (the hidden activation too).

#include "device_guard.cuh"
#include <math.h>

#include "gemm_f32.cuh"

namespace {

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

// LayerNorm of fp32 rows, fp32 out: one warp per row, the same sums as
// layernorm_kernel.
__global__ void __launch_bounds__(256)
layernorm_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ y, int M, int C,
                     float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (size_t)row * C;
  float sum = 0.f;
  for (int c = lane * 4; c < C; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    sum += v.x + v.y + v.z + v.w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / C;
  float sq = 0.f;
  for (int c = lane * 4; c < C; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    const float d[4] = {v.x - mean, v.y - mean, v.z - mean, v.w - mean};
    sq += d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / C + eps);
  float* yr = y + (size_t)row * C;
  for (int c = lane * 4; c < C; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    *reinterpret_cast<float4*>(yr + c) = make_float4(
        (v.x - mean) * rstd * gamma[c] + beta[c], (v.y - mean) * rstd * gamma[c + 1] + beta[c + 1],
        (v.z - mean) * rstd * gamma[c + 2] + beta[c + 2],
        (v.w - mean) * rstd * gamma[c + 3] + beta[c + 3]);
  }
}

}  // namespace

// x: (M, C) bf16; gamma, beta, b2, ls: (C,) fp32; w1: (hidden, C) bf16;
// b1: (hidden,) fp32; w2: (C, hidden) bf16; xn: (M, C) and hid: (M, hidden)
// bf16 scratch; out: (M, C) bf16. C and hidden must be multiples of 128, and
// x, w1, w2 16-byte aligned (the tensor maps' bases).
extern "C" int pi3_block_mlp(const void* x, const void* gamma, const void* beta, const void* w1,
                             const void* b1, const void* w2, const void* b2, const void* ls,
                             void* xn, void* hid, void* out, int M, int C, int hidden, float eps,
                             int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* xnb = static_cast<__nv_bfloat16*>(xn);
  auto* hb = static_cast<__nv_bfloat16*>(hid);
  layernorm_kernel<<<(M + 7) / 8, 256, 0, s>>>(xb, static_cast<const float*>(gamma),
                                               static_cast<const float*>(beta), xnb, M, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int code = pi3::launch_gemm<pi3::kGelu>(
      xnb, static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1), nullptr, nullptr,
      hb, M, hidden, C, s);
  if (code != 0) return code;
  return pi3::launch_gemm<pi3::kResidual>(
      hb, static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ls), xb, static_cast<__nv_bfloat16*>(out), M, C, hidden, s);
}

// x: (M, C) bf16; w1: (hidden, C) bf16; b1: (hidden,) fp32; w2: (C, hidden)
// bf16; b2: (C,) fp32; hid: (M, hidden) bf16 scratch; out: (M, C) bf16.
// C and hidden must be multiples of 128, and x, w1, w2 16-byte aligned.
extern "C" int pi3_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* hid, void* out, int M, int C, int hidden, int device,
                       void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  auto* hb = static_cast<__nv_bfloat16*>(hid);
  int code = pi3::launch_gemm<pi3::kGelu>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), nullptr, nullptr, hb, M, hidden, C, s);
  if (code != 0) return code;
  return pi3::launch_gemm<pi3::kBias>(
      hb, static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2), nullptr, nullptr,
      static_cast<__nv_bfloat16*>(out), M, C, hidden, s);
}

// The fp32 entries: every tensor above fp32 (x, the weights, the scratch xn
// and hid, out), the same widths; x, w1 and w2 16-byte aligned.
extern "C" int pi3_block_mlp_f32(const void* x, const void* gamma, const void* beta, const void* w1,
                                 const void* b1, const void* w2, const void* b2, const void* ls,
                                 void* xn, void* hid, void* out, int M, int C, int hidden,
                                 float eps, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xf = static_cast<const float*>(x);
  auto* xnf = static_cast<float*>(xn);
  auto* hf = static_cast<float*>(hid);
  layernorm_f32_kernel<<<(M + 7) / 8, 256, 0, s>>>(xf, static_cast<const float*>(gamma),
                                                   static_cast<const float*>(beta), xnf, M, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int code = pi3::launch_gemm_f32<pi3::kGelu>(xnf, static_cast<const float*>(w1),
                                              static_cast<const float*>(b1), nullptr, nullptr, hf,
                                              M, hidden, C, s);
  if (code != 0) return code;
  return pi3::launch_gemm_f32<pi3::kResidual>(
      hf, static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ls), xf, static_cast<float*>(out), M, C, hidden, s);
}

extern "C" int pi3_mlp_f32(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* hid, void* out, int M, int C, int hidden,
                           int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  auto* hf = static_cast<float*>(hid);
  int code = pi3::launch_gemm_f32<pi3::kGelu>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      nullptr, nullptr, hf, M, hidden, C, s);
  if (code != 0) return code;
  return pi3::launch_gemm_f32<pi3::kBias>(hf, static_cast<const float*>(w2),
                                          static_cast<const float*>(b2), nullptr, nullptr,
                                          static_cast<float*>(out), M, C, hidden, s);
}

// The GEMMs' dynamic shared memory a block, in bytes: bf16, fp32.
extern "C" int pi3_gemm_smem_bytes() { return pi3::kGemmSmemBytes; }
extern "C" int pi3_gemm_f32_smem_bytes() { return pi3::kF32GemmSmemBytes; }
