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
// Design: the key loop is flash_tile.cuh's exact running-max online softmax
// (P relative to the running max m keeps every bf16 P normal and full
// precision), and the epilogue rescales once by 2^(m - mh) <= 1/2 in fp32:
// exact up to rounding, and it underflows only where the plain fixed-shift
// sum does too. Keys are masked by length (Tk), with no padding to subtract.
// q, k and v are read through their (B, T, H, D) strides (last dim unit
// stride, rows 16-byte aligned), so the qkv projection's strided views need
// no copy.
//
// Bound on the H100: FLOPs, as packed_attention.cu (at the merge-2 shape
// 64,300 queries x 32,150 keys x 16 heads: 8.5 TFLOP per call). Simple first:
// K and V staged synchronously, mma.sync, no wgmma / TMA.

#include "flash_tile.cuh"

using namespace pi3;

namespace {

struct Strides {  // element strides of a (B, T, H, D) tensor
  long long b, t, h;
};

__global__ void __launch_bounds__(kThreads)
partial_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ kn,
                         float* __restrict__ acc, float* __restrict__ lsum, int Tq, int Tk, int H,
                         Strides qs, Strides ks, Strides vs, float scale_log2) {
  __shared__ __align__(16) Tile Qs;
  __shared__ __align__(16) Tile Ks;
  __shared__ __align__(16) Tile Vs;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  load_tile(Qs, qp, qs.t, q0, Tq);
  __syncthreads();
  FlashRows<kD> st;
  init_rows(st, Qs);

  // |q|^2 per row from the fragments: the quad's four threads hold the row's
  // 64 columns (regs 0 / 2: row r0; 1 / 3: row r0 + 8)
  float qq0 = 0.f, qq1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a bf16 is the upper half of the fp32 with the same value
      const float lo = __uint_as_float(st.qf[kk][j] << 16);
      const float hi = __uint_as_float(st.qf[kk][j] & 0xffff0000u);
      const float sq = lo * lo + hi * hi;
      if (j & 1) qq1 += sq; else qq0 += sq;
    }
  }
  qq0 += __shfl_xor_sync(0xffffffffu, qq0, 1);
  qq0 += __shfl_xor_sync(0xffffffffu, qq0, 2);
  qq1 += __shfl_xor_sync(0xffffffffu, qq1, 1);
  qq1 += __shfl_xor_sync(0xffffffffu, qq1, 2);
  const float knh = kn[b * H + h];
  const float mh0 = fminf(sqrtf(qq0) * scale_log2 * knh + 1.f, 120.f);
  const float mh1 = fminf(sqrtf(qq1) * scale_log2 * knh + 1.f, 120.f);

  for (int k0 = 0; k0 < Tk; k0 += kTile) {
    __syncthreads();  // previous tile fully consumed
    load_tile(Ks, kp, ks.t, k0, Tk);
    load_tile(Vs, vp, vs.t, k0, Tk);
    __syncthreads();
    attend_tile(st, Ks, Vs, k0, Tk, scale_log2);
  }
  reduce_row_sums(st);
  // from the running max m to the fixed shift mh (m <= mh - 1 unless the
  // clamp at 120 binds, so the factor is at most 1/2 there)
  const float f0 = exp2f(st.m0 - mh0);
  const float f1 = exp2f(st.m1 - mh1);

  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row_a = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  // acc (B, Tq, H, 64) and l (B, Tq, H), contiguous fp32
  const size_t ra = ((size_t)b * Tq + row_a) * H + h;
  const size_t rb = ra + (size_t)8 * H;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (row_a < Tq)
      *reinterpret_cast<float2*>(acc + ra * kD + n * 8 + 2 * t4) =
          make_float2(st.o[n][0] * f0, st.o[n][1] * f0);
    if (row_b < Tq)
      *reinterpret_cast<float2*>(acc + rb * kD + n * 8 + 2 * t4) =
          make_float2(st.o[n][2] * f1, st.o[n][3] * f1);
  }
  if (t4 == 0) {
    if (row_a < Tq) lsum[ra] = st.l0 * f0;
    if (row_b < Tq) lsum[rb] = st.l1 * f1;
  }
}

}  // namespace

// q (B, Tq, H, 64), k / v (B, Tk, H, 64) bf16 with the given element strides
// (unit stride over the last dim); kn (B, H) fp32; acc (B, Tq, H, 64) and
// l (B, Tq, H) fp32, contiguous. scale_log2 = 64^-1/2 * log2(e).
extern "C" int pi3_partial_attention(const void* q, const void* k, const void* v, const void* kn,
                                     void* acc, void* l, int B, int Tq, int Tk, int H,
                                     long long q_sb, long long q_st, long long q_sh,
                                     long long k_sb, long long k_st, long long k_sh,
                                     long long v_sb, long long v_st, long long v_sh,
                                     float scale_log2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kTile - 1) / kTile, H, B);
  partial_attention_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(kn),
      static_cast<float*>(acc), static_cast<float*>(l), Tq, Tk, H, Strides{q_sb, q_st, q_sh},
      Strides{k_sb, k_st, k_sh}, Strides{v_sb, v_st, v_sh}, scale_log2);
  return (int)cudaGetLastError();
}
