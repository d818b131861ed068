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
// (its header has the design and the tiles of each head dim). Bound on the
// H100: FLOPs, 4 * Tq * Tk * D per (batch, head): 16.9 TFLOP at (1, 64300,
// 16, 64), 17.1 ms at 989 TFLOP/s.
//
// Any wider multiple of 64 (320, 384, ...; no configuration of either package
// uses one) takes the column-sliced wide kernel of flash_tile.cuh's mma.sync
// loop, unchanged: the grid gains a column-slice dimension, and each block
// owns a DV-wide slice of O (DV = 128 where 128 divides D, else 64). The
// block recomputes the full logits Q K^T for its slice, staging Q and K in
// 64-column chunks through two __syncthreads: D/DV times the q.k^T work of
// one pass, and no shared-memory limit on D.

#include "bthd_attention.cuh"
#include "flash_tile.cuh"

using namespace pi3;

namespace {

// The wide kernel: blockIdx.y = h * (D / DV) + slice; the block's O slice
// holds columns [slice * DV, slice * DV + DV) of head h.
template <int DV>
__global__ void __launch_bounds__(kThreads)
attention_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      int Tq, int Tk, int H, int D, BthdStrides qs, BthdStrides ks, BthdStrides vs,
                      float scale_log2) {
  __shared__ __align__(16) Tile Qs;  // 64 columns of Q
  __shared__ __align__(16) Tile Ks;  // the same 64 columns of K
  __shared__ __align__(16) TileD<DV> Vs;

  const int n_slices = D / DV;
  const int h = blockIdx.y / n_slices;
  const int c0 = (blockIdx.y - h * n_slices) * DV;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h + c0;

  FlashRows<DV> st;  // Q comes in 64-column chunks
  reset_rows(st);
  for (int k0 = 0; k0 < Tk; k0 += kTile) {
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int c = 0; c < D; c += kD) {
      __syncthreads();  // previous chunk (and tile's V) fully consumed
      load_tile(Qs, qp + c, qs.t, q0, Tq);
      load_tile(Ks, kp + c, ks.t, k0, Tk);
      if (c == 0) load_tile(Vs, vp, vs.t, k0, Tk);
      __syncthreads();
      uint32_t qf[kD / 16][4];
      load_q_fragments<kD>(qf, Qs);
      tile_logits<kD>(s, qf, Ks);
    }
    online_softmax(st, s, k0, Tk, scale_log2);
    tile_pv<DV>(st.o, s, Vs);
  }
  reduce_row_sums(st);
  const float inv0 = 1.f / st.l0;
  const float inv1 = 1.f / st.l1;

  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row_a = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  __nv_bfloat16* oa = out + (((size_t)b * Tq + row_a) * H + h) * D + c0 + 2 * t4;
  __nv_bfloat16* ob = oa + (size_t)8 * H * D;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    if (row_a < Tq)
      *reinterpret_cast<uint32_t*>(oa + n * 8) = pack_float2(st.o[n][0] * inv0, st.o[n][1] * inv0);
    if (row_b < Tq)
      *reinterpret_cast<uint32_t*>(ob + n * 8) = pack_float2(st.o[n][2] * inv1, st.o[n][3] * inv1);
  }
}

template <int DV>
int launch_wide(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tk,
                int H, int D, BthdStrides qs, BthdStrides ks, BthdStrides vs, float scale_log2,
                cudaStream_t stream) {
  dim3 grid((Tq + kTile - 1) / kTile, H * (D / DV), B);
  attention_wide_kernel<DV><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Tq, Tk, H, D, qs,
      ks, vs, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, D), k / v (B, Tk, H, D) bf16 with the given element strides
// (unit stride over the last dim, the others multiples of 8, bases 16-byte
// aligned); out (B, Tq, H, D) bf16, contiguous. D must be a positive multiple
// of 64 (cudaErrorInvalidValue otherwise): 64 to 256 take the TMA + wgmma
// kernel, wider ones the wide one. scale_log2 = D^-1/2 * log2(e) multiplies
// the fp32 logits (base-2 softmax).
extern "C" int pi3_attention(const void* q, const void* k, const void* v, void* out, int B, int Tq,
                             int Tk, int H, int D, long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh, long long v_sb,
                             long long v_st, long long v_sh, float scale_log2, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const BthdStrides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch_bthd_attention<64, false>(q, k, v, out, nullptr, nullptr, B, Tq, Tk, H, qs, ks,
                                              vs, scale_log2, s);
    case 128:
      return launch_bthd_attention<128, false>(q, k, v, out, nullptr, nullptr, B, Tq, Tk, H, qs,
                                               ks, vs, scale_log2, s);
    case 192:
      return launch_bthd_attention<192, false>(q, k, v, out, nullptr, nullptr, B, Tq, Tk, H, qs,
                                               ks, vs, scale_log2, s);
    case 256:
      return launch_bthd_attention<256, false>(q, k, v, out, nullptr, nullptr, B, Tq, Tk, H, qs,
                                               ks, vs, scale_log2, s);
    default:
      if (D <= 0 || D % 64) return (int)cudaErrorInvalidValue;
      if (D % 128 == 0)
        return launch_wide<128>(q, k, v, out, B, Tq, Tk, H, D, qs, ks, vs, scale_log2, s);
      return launch_wide<64>(q, k, v, out, B, Tq, Tk, H, D, qs, ks, vs, scale_log2, s);
  }
}
