// Packed-qkv attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pi3_slam_tpu/ops/pallas_attention.py:
//   flash_attention_packed_tpu        (_flash_packed_kernel, global blocks)
//   attention_single_pass_packed_tpu  (_single_pass_packed_kernel, frame,
//                                      encoder and head blocks)
// Both compute out = softmax_2(s * q.k^T) . v per head over the packed
// (B, T, 3*H*64) qkv-projection layout, writing (B, t, H*64) in place: head h
// of q/k/v sits at columns h*64, C+h*64, 2C+h*64 with row stride 3C. On the
// TPU they differed by how much of T fit in VMEM; on Hopper one online-softmax
// loop over 64-key tiles serves both (a whole 1280-row K+V tile would not fit
// the 227 KB of shared memory anyway). The TPU kernels' Cauchy-Schwarz bound
// shift is replaced by an exact running max, and zero padding keys are masked
// by length (t_valid) instead of being subtracted from the denominator.
//
// Bound on the H100: FLOPs. At the global shape (1, 64300, 3072) a block
// does 4*T^2*64*16 = 16.9 TFLOP against 0.4 GB of traffic (~40,000 flop per
// byte); the frame shape (100, 643, 3072) is ~640 flop per byte. So the
// matrix products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate) with the softmax in fp32 registers, and q stays in registers
// for the whole key loop. This first version stages K and V synchronously
// (no cp.async / TMA pipeline, no wgmma): simple and right first.
//
// Tiling: one block of 4 warps per (64-query tile, head, batch row); each warp
// owns 16 query rows. Per 64-key tile: S = Q K^T (32 mma), online softmax on
// the S fragments, P converted in registers to the A operand, O += P V (32
// mma).

#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128; // 4 warps x 16 query rows
constexpr int kLd = kD + 8;   // padded shared-memory row (bf16), 144 bytes

// rows [row0, row0+64) x 64 columns of a row-major bf16 matrix with row
// stride ld -> smem; rows >= n_rows are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kLd], const __nv_bfloat16* src,
                                          int ld, int row0, int n_rows) {
  for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
packed_attention_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                        int T, int H, int t_valid, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBQ][kLd];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK][kLd];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK][kLd];

  const int C = H * kD;
  const int ld = 3 * C;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* base = qkv + (size_t)b * T * ld;
  const __nv_bfloat16* qp = base + h * kD;
  const __nv_bfloat16* kp = base + C + h * kD;
  const __nv_bfloat16* vp = base + 2 * C + h * kD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  load_tile(Qs, qp, ld, q0, t_valid);
  __syncthreads();
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qf[kk][0] = pi3::ld_pair(&Qs[r0][c]);
    qf[kk][1] = pi3::ld_pair(&Qs[r0 + 8][c]);
    qf[kk][2] = pi3::ld_pair(&Qs[r0][c + 8]);
    qf[kk][3] = pi3::ld_pair(&Qs[r0 + 8][c + 8]);
  }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows r0 / r0+8
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums

  for (int k0 = 0; k0 < t_valid; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    load_tile(Ks, kp, ld, k0, t_valid);
    load_tile(Vs, vp, ld, k0, t_valid);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const int key = n * 8 + g;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = kk * 16 + 2 * t4;
        pi3::mma_bf16_16816(s[n], qf[kk], pi3::ld_pair(&Ks[key][c]), pi3::ld_pair(&Ks[key][c + 8]));
      }
    }

    // scale to base-2 logits, mask keys >= t_valid, tile row max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + n * 8 + 2 * t4 + j < t_valid;
        s[n][j] = ok ? s[n][j] * scale_log2 : -INFINITY;
        s[n][2 + j] = ok ? s[n][2 + j] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
    // the four threads of a quad hold one row's 64 columns
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key k0 < t_valid is in every visited tile, so the new max is finite
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0);  // 0 on the first tile (m = -inf)
    const float a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P V: the S accumulator layout of key tiles (2kk, 2kk+1) is the A
    // operand layout of a 16-key step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pi3::pack_float2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pi3::pack_float2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pi3::pack_float2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pi3::pack_float2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 = pi3::pack_pair(Vs[key][col], Vs[key + 1][col]);
        const uint32_t b1 = pi3::pack_pair(Vs[key + 8][col], Vs[key + 9][col]);
        pi3::mma_bf16_16816(o[n], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;

  const int row_a = q0 + r0;
  const int row_b = row_a + 8;
  __nv_bfloat16* oa = out + ((size_t)b * t_valid + row_a) * C + h * kD + 2 * t4;
  __nv_bfloat16* ob = oa + (size_t)8 * C;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (row_a < t_valid)
      *reinterpret_cast<uint32_t*>(oa + n * 8) = pi3::pack_float2(o[n][0] * inv0, o[n][1] * inv0);
    if (row_b < t_valid)
      *reinterpret_cast<uint32_t*>(ob + n * 8) = pi3::pack_float2(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace

// qkv: (B, T, 3*H*64) bf16, contiguous; out: (B, t_valid, H*64) bf16.
// Keys and queries with index >= t_valid are ignored. scale_log2 multiplies
// the fp32 logits (base-2 softmax).
extern "C" int pi3_packed_attention(const void* qkv, void* out, int B, int T, int H,
                                    int t_valid, float scale_log2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_valid + kBQ - 1) / kBQ, H, B);
  packed_attention_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), T, H, t_valid,
      scale_log2);
  return (int)cudaGetLastError();
}
