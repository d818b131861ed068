// Bound-shift partial attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_partial_tpu
// (_flash_fwd_partial_kernel) of pi3_slam_tpu/ops/pallas_attention.py, which
// the kv-merge global blocks run with Tq != Tk (and the ring step with one key
// shard each). Per query row r of head h it returns the unnormalised
//   acc_r = sum_j 2^(s_rj - mh_r) v_j      l_r = sum_j 2^(s_rj - mh_r)
// with s_rj = q_r.k_j * D^-1/2 * log2(e) and the fixed per-row shift
//   mh_r = min(|q_r| * D^-1/2 * log2(e) * kn_h + 1, 120),
// kn_h the GLOBAL max |k| of the head (over every key shard). Since
// s_rj <= mh_r - 1 by Cauchy-Schwarz, partials over key shards that share kn
// sum exactly; the caller divides once. The shift is the contract, not a TPU
// workaround, so acc and l themselves carry the 2^(-mh) scale.
//
// Design: bthd_attention.cuh's TMA + wgmma loop at head dim 64 (its header
// has the loads, products and overlap), with its own epilogue. The loop keeps
// an exact running max m (P relative to it keeps every bf16 P normal and full
// precision), and the epilogue rescales once by 2^(m - mh) <= 1/2 in fp32:
// exact up to rounding, and it underflows only where the plain fixed-shift sum
// does too. |q| comes from Q in shared memory at the end, each row's
// swizzled chunks summed whatever their order, so every key shard computes the
// same mh for a row. Keys are masked by length (Tk), with no padding to
// subtract. q, k and v are read through their (B, T, H, D) strides (last dim
// unit stride, strides and base 16-byte aligned), so the qkv projection's
// strided views need no copy.
//
// Bound on the H100: FLOPs, as packed_attention.cu (at the merge-2 shape
// 64,300 queries x 32,150 keys x 16 heads: 8.5 TFLOP per call, 8.6 ms at 989
// TFLOP/s), and at head dim 64 as many exp2 on the special-function units.

#include "device_guard.cuh"
#include "bthd_attention.cuh"

using namespace pi3;

// q (B, Tq, H, 64), k / v (B, Tk, H, 64) bf16 with the given element strides
// (unit stride over the last dim, the others multiples of 8, bases 16-byte
// aligned); kn (B, H) fp32; acc (B, Tq, H, 64) and l (B, Tq, H) fp32,
// contiguous. scale_log2 = 64^-1/2 * log2(e). Returns a cudaError_t.
extern "C" int pi3_partial_attention(const void* q, const void* k, const void* v, const void* kn,
                                     void* acc, void* l, int B, int Tq, int Tk, int H,
                                     long long q_sb, long long q_st, long long q_sh,
                                     long long k_sb, long long k_st, long long k_sh,
                                     long long v_sb, long long v_st, long long v_sh,
                                     float scale_log2, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  return launch_bthd_attention<64, kPartialSums>(
      q, k, v, acc, static_cast<const float*>(kn), static_cast<float*>(l), B, Tq, Tk, H,
      BthdStrides{q_sb, q_st, q_sh}, BthdStrides{k_sb, k_st, k_sh}, BthdStrides{v_sb, v_st, v_sh},
      scale_log2, (cudaStream_t)stream);
}
