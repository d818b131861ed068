// Attention in float32 for Hopper (sm_90a): the fp32 entries of every
// attention row of PERF.md's kernel table, over (B, T, H, D) q / k / v read
// through their strides.
//
// Replaces, for float32 inputs, the Pallas TPU kernels of
// pi3_slam_tpu/ops/pallas_attention.py, which take any input dtype (on the
// TPU an fp32 model runs them in fp32: p is cast to v's dtype):
//   flash_attention_packed_tpu, attention_single_pass_packed_tpu (rows 1-2):
//     the packed (B, T, 3*H*64) projection as q / k / v views (row stride 3C,
//     head stride 64, row extent t_valid), any q_scale;
//   flash_attention_partial_tpu (row 5): the same loop with the partial
//     epilogue (unnormalised numerator and denominator, fixed shift);
//   flash_attention_tpu, attention_single_pass_tpu (rows 6-7): (B, T, H, D)
//     at every head dim that is a multiple of 64, keys masked by length.
// Per (batch, head), in fp32 throughout (P is kept in fp32, as the JAX fp32
// path keeps it):
//   s = scale * q.k^T (base 2), keys >= Tk masked, out = softmax_2(s) . v
// normalised (pi3_attention_f32), or acc = sum_j 2^(s_j - mh) v_j and l =
// sum_j 2^(s_j - mh) with mh = min(|q| scale kn + 1, 120)
// (pi3_partial_attention_f32; see partial_attention.cu for the contract).
// The scale multiplies the logits before the running max, so any scale
// (0 and negative ones too) is taken as it is.
//
// Head dim 64 (every fp32 launch of the main paths, the partial one too)
// runs the TMA + wgmma tf32 loop of bthd_attention_f32.cuh
// (attention_f32_tma_kernel); every wider multiple of 64 its sliced variant
// in the same header (attention_f32_wide_tma_kernel: O in column slices of
// 128, S recomputed over all of D per slice in 96-key tiles, K's and Q's
// 32-column boxes streamed through a ring of units, V's slice in stages of
// 32 keys). Both run the products on the tensor cores in TF32 with the 3xTF32
// split done once per element (an fp32 pattern's raw bits as the big part,
// tf32_small as the small one) and add each group of 4 k8 steps in fp32,
// since the tensor cores truncate when they accumulate: fp32's accuracy,
// where TF32 alone would keep ~3 digits.
//
// Bound on the H100: operations, 4 Tq Tk D per (batch, head) over 3xTF32's
// 165 TFLOP/s (a third of TF32's 495); at MoGe-2's encoder shape (1, 3537, 6
// x 64) 1.9e10, 0.12 ms. The sliced variant does (slices + 1) / 2 times
// that work (each slice recomputes S).

#include "device_guard.cuh"
#include <math.h>

#include "bthd_attention_f32.cuh"

using namespace pi3;

// q (B, Tq, H, D), k / v (B, Tk, H, D) fp32 with the given element strides
// (unit stride over D, the others multiples of 4, bases 16-byte aligned);
// out (B, Tq, H, D) fp32, contiguous: softmax_2(scale * q.k^T) . v with keys
// >= Tk masked. D must be a positive multiple of 64 (cudaErrorInvalidValue
// otherwise): 64 on the TMA + wgmma loop, wider ones on its sliced variant.
// Returns a cudaError_t.
extern "C" int pi3_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                 int Tq, int Tk, int H, int D, long long q_sb, long long q_st,
                                 long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh, float scale,
                                 int device, void* stream) {
  if (D <= 0 || D % 64) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  const BthdStrides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_attention_f32_tma<kSoftmax>(qp, kp, vp, op, nullptr, nullptr, B, Tq, Tk, H, qs,
                                              ks, vs, scale, s);
  return launch_attention_f32_wide(qp, kp, vp, op, B, Tq, Tk, H, D, qs, ks, vs, scale, s);
}

// The partial epilogue at head dim 64: q, k, v as above; kn (B, H) fp32; acc
// (B, Tq, H, 64) and l (B, Tq, H) fp32, contiguous. scale = 64^-1/2 log2(e).
extern "C" int pi3_partial_attention_f32(const void* q, const void* k, const void* v,
                                         const void* kn, void* acc, void* l, int B, int Tq, int Tk,
                                         int H, long long q_sb, long long q_st, long long q_sh,
                                         long long k_sb, long long k_st, long long k_sh,
                                         long long v_sb, long long v_st, long long v_sh,
                                         float scale, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  return launch_attention_f32_tma<kPartialSums>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(acc), static_cast<const float*>(kn), static_cast<float*>(l), B, Tq, Tk,
      H, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}, scale,
      (cudaStream_t)stream);
}
