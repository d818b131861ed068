// Dots-only packed attention for Hopper (sm_90a): the speed-of-light twin of
// flash_tile.cuh's mma.sync loop (which served rows 5-7 of PERF.md's kernel
// table until they moved to bthd_attention.cuh's TMA + wgmma loop).
//
// Replaces the Pallas TPU kernel dots_kernel of tools/perf_lab.py::bench_sol
// (the "dots-only twin of _flash_packed_kernel"). Over the packed
// (B, T, 3*H*64) bf16 layout (head h of q / k / v at columns h*64, C+h*64,
// 2C+h*64, C = H*64) it computes, per head,
//
//   out[b, t, h*64:(h+1)*64] = bf16( sum_k bf16(q_h[t] . k_h[k]) * v_h[k] )
//
// with both products accumulated in fp32 and the logits rounded to bf16 (round
// to nearest even) before the second product. No softmax, no scale. The TPU
// kernel also summed each row of the bf16 logits through an extra ones-column
// of v and then dropped that sum from its output; that sum is dead work and is
// not computed here. The TPU's 128-lane head pairing is not carried over.
//
// Design: flash_tile.cuh's loop, which has no softmax. The same block
// (4 warps, 64 query rows of one head), the same 64-key tiles staged through
// shared memory, the same mma.sync m16n8k16 for S = Q K^T (tile_logits) and
// O += bf16(S) V (tile_pv), the same output write. So its time is the floor
// of that loop without its softmax. packed_attention.cu and
// bthd_attention.cuh run another loop (TMA + wgmma), and their times beside
// this one's are not the cost of a softmax.
// Zero-filled key rows past T give logits of exactly 0, and their v rows are
// zero, so no key mask is needed.
//
// Bound on the H100: FLOPs, 4 * T^2 * 64 per (batch, head): 1.76e13 at
// (1, 65536, 3072), 17.8 ms at 989 TFLOP/s.

#include "flash_tile.cuh"

using namespace pi3;

namespace {

__global__ void __launch_bounds__(kThreads)
dots_attention_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                      int T, int H) {
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

  load_tile(Qs, qp, ld, q0, T);
  __syncthreads();
  uint32_t qf[kD / 16][4];
  load_q_fragments<kD>(qf, Qs);
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int k0 = 0; k0 < T; k0 += kTile) {
    __syncthreads();  // previous tile fully consumed
    load_tile(Ks, kp, ld, k0, T);
    load_tile(Vs, vp, ld, k0, T);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    tile_logits<kD>(s, qf, Ks);
    tile_pv<kD>(o, s, Vs);
  }

  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row_a = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  __nv_bfloat16* oa = out + ((size_t)b * T + row_a) * C + h * kD + 2 * t4;
  __nv_bfloat16* ob = oa + (size_t)8 * C;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    if (row_a < T) *reinterpret_cast<uint32_t*>(oa + n * 8) = pack_float2(o[n][0], o[n][1]);
    if (row_b < T) *reinterpret_cast<uint32_t*>(ob + n * 8) = pack_float2(o[n][2], o[n][3]);
  }
}

}  // namespace

// qkv: (B, T, 3*H*64) bf16, contiguous; out: (B, T, H*64) bf16, contiguous.
extern "C" int pi3_dots_attention(const void* qkv, void* out, int B, int T, int H, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kTile - 1) / kTile, H, B);
  dots_attention_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), T, H);
  return (int)cudaGetLastError();
}
