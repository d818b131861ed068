// Dots-only packed attention for Hopper (sm_90a): the speed-of-light twin of
// the attention kernels, the products-only mode of bthd_attention.cuh's TMA +
// wgmma loop.
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
// Design: bthd_attention.cuh's loop in its products-only mode, launched over
// the packed projection as q / k / v views (row stride 3C, head stride 64,
// row extent T): the same ring (128-key tiles, 3 stages), warpgroups,
// ping-pong and issue order as the softmax loop of attention.cu and
// partial_attention.cu (and, through the same design, packed_attention.cu),
// without the running max, the exp2 and the row sums. So its time beside
// theirs at the same shape is the cost of the softmax on this loop. Zero-
// filled key rows past T give logits of exactly 0 against v rows of 0, so no
// key mask is needed.
//
// Bound on the H100: FLOPs, 4 * T^2 * 64 per (batch, head): 1.76e13 at
// (1, 65536, 3072), 17.8 ms at 989 TFLOP/s.

#include "device_guard.cuh"
#include "bthd_attention.cuh"

using namespace pi3;

// qkv: (B, T, 3*H*64) bf16, contiguous, 16-byte aligned; out: (B, T, H*64)
// bf16, contiguous. Returns a cudaError_t.
extern "C" int pi3_dots_attention(const void* qkv, void* out, int B, int T, int H, int device,
                                  void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  const long long c = 64ll * H;
  const BthdStrides st{(long long)T * 3 * c, 3 * c, 64};  // q, k and v views of the projection
  const auto* base = static_cast<const __nv_bfloat16*>(qkv);
  return launch_bthd_attention<64, kProductsOnly>(base, base + c, base + 2 * c, out, nullptr,
                                                  nullptr, B, T, T, H, st, st, st, 1.f,
                                                  (cudaStream_t)stream);
}
