// Attention over (B, T, H, D) q / k / v for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pi3_slam_tpu/ops/pallas_attention.py,
// which ops/attention.py::sdpa routes to by sequence length:
//   flash_attention_tpu        (_flash_fwd_bound_kernel "bound" and
//                               _flash_fwd_kernel "max"; 1280 < T)
//   attention_single_pass_tpu  (_attn_single_pass_bound_kernel and
//                               _attn_single_pass_kernel; 256 <= T <= 1280)
// Both compute out = softmax(q.k^T * D^-1/2) . v per (batch, head) and write
// it in the input dtype (bf16). One kernel serves both entry points, as
// packed_attention.cu does for the packed pair: on the TPU they differed by
// how much of T fit in VMEM, which does not apply to Hopper's 227 KB of
// shared memory. The exact running max of the online softmax matches both
// TPU variants ("bound" fixed a Cauchy-Schwarz shift, "max" kept a running
// max); the TPU's lattice padding, its padded-key correction and its
// n_interleave are not carried over. Keys are masked by length, so Tk != Tq
// works (the TPU kernels pad k to q's lattice and assume Tk == Tq).
//
// q, k and v are read through their (B, T, H, D) strides (unit-stride last
// dim, strides and base 16-byte aligned), so the q / k / v views of a qkv
// projection need no copy. The softmax scale D^-1/2 * log2(e) multiplies the
// fp32 logits. The output is (B, Tq, H, D) contiguous, normalised by the row
// sum.
//
// Head dims 64, 128, 192 and 256 run bthd_attention.cuh's TMA + wgmma loop
// (its header has the design, the tiles of each head dim and their times:
// 128-key tiles on a ring of three stages at D 64 and 128; at D 192 and 256
// 80-key tiles on two stages, K and V each on mbarriers of their own, so
// that a stage's refill need not wait for the P V of its tile). Bound on the
// H100: FLOPs, 4 * Tq * Tk * D per (batch, head): 16.9 TFLOP at (1, 64300,
// 16, 64), 17.1 ms at 989 TFLOP/s; 0.278 ms at (1, 8192, 4, 256).
//
// Any wider multiple of 64 (320, 384, ...; no configuration of either
// package uses one) runs the same loop's wide variant (the end of
// bthd_attention.cuh): 64-row blocks of one consumer warpgroup, O in as few
// column slices as the registers allow (one at D 320, ceil(D / 256) above),
// each slice a block that computes the full logits, Q's and K's 64-column
// boxes streamed through a ring so that shared memory does not grow with D.
// Bound: the same FLOPs, 0.044 ms at (1, 4100, 2, 320) and 0.107 ms at
// (100, 643, 2, 320).

#include "device_guard.cuh"
#include "bthd_attention.cuh"

using namespace pi3;

namespace {

// Head dims D > 256, multiples of 64: the slice width picks the kernel.
// Returns a cudaError_t.
int launch_wide(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tk,
                int H, int D, BthdStrides qs, BthdStrides ks, BthdStrides vs, float scale_log2,
                cudaStream_t stream) {
  const WidePlan plan = wide_plan(D);
  switch (plan.dv) {
    case 192:
      return launch_bthd_wide<192>(q, k, v, out, B, Tq, Tk, H, D, plan, qs, ks, vs, scale_log2,
                                   stream);
    case 256:
      return launch_bthd_wide<256>(q, k, v, out, B, Tq, Tk, H, D, plan, qs, ks, vs, scale_log2,
                                   stream);
    case 320:
      return launch_bthd_wide<320>(q, k, v, out, B, Tq, Tk, H, D, plan, qs, ks, vs, scale_log2,
                                   stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Tq, H, D), k / v (B, Tk, H, D) bf16 with the given element strides
// (unit stride over the last dim, the others multiples of 8, bases 16-byte
// aligned); out (B, Tq, H, D) bf16, contiguous. D must be a positive multiple
// of 64 (cudaErrorInvalidValue otherwise): 64 to 256 take the TMA + wgmma
// kernel, wider ones its wide variant. scale_log2 = D^-1/2 * log2(e)
// multiplies the fp32 logits (base-2 softmax).
extern "C" int pi3_attention(const void* q, const void* k, const void* v, void* out, int B, int Tq,
                             int Tk, int H, int D, long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh, long long v_sb,
                             long long v_st, long long v_sh, float scale_log2, int device,
                             void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  const BthdStrides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch_bthd_attention<64, kSoftmax>(q, k, v, out, nullptr, nullptr, B, Tq, Tk, H,
                                                   qs, ks, vs, scale_log2, s);
    case 128:
      return launch_bthd_attention<128, kSoftmax>(q, k, v, out, nullptr, nullptr, B, Tq, Tk, H,
                                                   qs, ks, vs, scale_log2, s);
    case 192:
      return launch_bthd_attention<192, kSoftmax>(q, k, v, out, nullptr, nullptr, B, Tq, Tk, H,
                                                   qs, ks, vs, scale_log2, s);
    case 256:
      return launch_bthd_attention<256, kSoftmax>(q, k, v, out, nullptr, nullptr, B, Tq, Tk, H,
                                                   qs, ks, vs, scale_log2, s);
    default:
      if (D <= 256 || D % 64) return (int)cudaErrorInvalidValue;
      return launch_wide(q, k, v, out, B, Tq, Tk, H, D, qs, ks, vs, scale_log2, s);
  }
}
