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
// Tiling: one block of 4 warps per (64-query tile, head, batch row); the key
// loop is flash_tile.cuh's, shared with partial_attention.cu.

#include "flash_tile.cuh"

using namespace pi3;

namespace {

__global__ void __launch_bounds__(kThreads)
packed_attention_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                        int T, int H, int t_valid, float scale_log2) {
  __shared__ __align__(16) Tile Qs;
  __shared__ __align__(16) Tile Ks;
  __shared__ __align__(16) Tile Vs;

  const int C = H * kD;
  const int ld = 3 * C;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* base = qkv + (size_t)b * T * ld;
  const __nv_bfloat16* qp = base + h * kD;
  const __nv_bfloat16* kp = base + C + h * kD;
  const __nv_bfloat16* vp = base + 2 * C + h * kD;

  load_tile(Qs, qp, ld, q0, t_valid);
  __syncthreads();
  FlashRows<kD> st;
  init_rows(st, Qs);
  for (int k0 = 0; k0 < t_valid; k0 += kTile) {
    __syncthreads();  // previous tile fully consumed
    load_tile(Ks, kp, ld, k0, t_valid);
    load_tile(Vs, vp, ld, k0, t_valid);
    __syncthreads();
    attend_tile(st, Ks, Vs, k0, t_valid, scale_log2);
  }
  reduce_row_sums(st);
  const float inv0 = 1.f / st.l0;
  const float inv1 = 1.f / st.l1;

  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row_a = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  __nv_bfloat16* oa = out + ((size_t)b * t_valid + row_a) * C + h * kD + 2 * t4;
  __nv_bfloat16* ob = oa + (size_t)8 * C;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (row_a < t_valid)
      *reinterpret_cast<uint32_t*>(oa + n * 8) = pack_float2(st.o[n][0] * inv0, st.o[n][1] * inv0);
    if (row_b < t_valid)
      *reinterpret_cast<uint32_t*>(ob + n * 8) = pack_float2(st.o[n][2] * inv1, st.o[n][3] * inv1);
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
  dim3 grid((t_valid + kTile - 1) / kTile, H, B);
  packed_attention_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), T, H, t_valid,
      scale_log2);
  return (int)cudaGetLastError();
}
