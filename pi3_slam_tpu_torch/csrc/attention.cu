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
// shared memory. The exact running max of flash_tile.cuh's online softmax
// matches both TPU variants ("bound" fixed a Cauchy-Schwarz shift, "max" kept
// a running max); the TPU's lattice padding, its padded-key correction and
// its n_interleave are not carried over. Keys are masked by length, so
// Tk != Tq works (the TPU kernels pad k to q's lattice and assume Tk == Tq).
//
// q, k and v are read through their (B, T, H, D) strides (unit-stride last
// dim, rows 16-byte aligned), so the q / k / v views of a qkv projection need
// no copy. The softmax scale D^-1/2 * log2(e) multiplies the fp32 logits.
// The output is (B, Tq, H, D) contiguous, normalised by the row sum.
//
// Head dim D = 64 or 128 (a template parameter of the tile loop). Three
// 64-row tiles take 27,648 bytes at D = 64 and 52,224 at D = 128, over the
// 48 KB of static shared memory, so the tiles live in dynamic shared memory
// and D = 128 opts in to the larger size. At D = 128 the O fragments double
// to 64 fp32 registers a thread.
//
// Any other multiple of 64 (192, 256, ...) takes the wide kernel: the grid
// gains a column-slice dimension, and each block owns a DV-wide slice of O
// (DV = 128 where 128 divides D, else 64). Its O fragments stay those of the
// D = DV tile, so no head dim costs more registers than D = 128. The block
// recomputes the full logits Q K^T for its slice, staging Q and K in 64-column
// chunks (Q is re-read once per key tile, from L2): D/DV times the q.k^T work
// of one pass, and no shared-memory limit on D.
//
// Bound on the H100: FLOPs, as packed_attention.cu (4 * Tq * Tk * D per
// (batch, head): 16.9 TFLOP at (1, 64300, 16, 64)). Simple first: K and V
// staged synchronously, mma.sync, no wgmma / TMA.

#include "flash_tile.cuh"

using namespace pi3;

namespace {

struct Strides {  // element strides of a (B, T, H, D) tensor
  long long b, t, h;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Tq,
                 int Tk, int H, Strides qs, Strides ks, Strides vs, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  TileD<D>& Qs = *reinterpret_cast<TileD<D>*>(smem);
  TileD<D>& Ks = *reinterpret_cast<TileD<D>*>(smem + sizeof(TileD<D>));
  TileD<D>& Vs = *reinterpret_cast<TileD<D>*>(smem + 2 * sizeof(TileD<D>));

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  load_tile(Qs, qp, qs.t, q0, Tq);
  __syncthreads();
  FlashRows<D> st;
  init_rows(st, Qs);
  for (int k0 = 0; k0 < Tk; k0 += kTile) {
    __syncthreads();  // previous tile fully consumed
    load_tile(Ks, kp, ks.t, k0, Tk);
    load_tile(Vs, vp, vs.t, k0, Tk);
    __syncthreads();
    attend_tile(st, Ks, Vs, k0, Tk, scale_log2);
  }
  reduce_row_sums(st);
  const float inv0 = 1.f / st.l0;
  const float inv1 = 1.f / st.l1;

  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int row_a = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  // out (B, Tq, H, D) contiguous
  __nv_bfloat16* oa = out + (((size_t)b * Tq + row_a) * H + h) * D + 2 * t4;
  __nv_bfloat16* ob = oa + (size_t)8 * H * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row_a < Tq)
      *reinterpret_cast<uint32_t*>(oa + n * 8) = pack_float2(st.o[n][0] * inv0, st.o[n][1] * inv0);
    if (row_b < Tq)
      *reinterpret_cast<uint32_t*>(ob + n * 8) = pack_float2(st.o[n][2] * inv1, st.o[n][3] * inv1);
  }
}

// The wide kernel: blockIdx.y = h * (D / DV) + slice; the block's O slice
// holds columns [slice * DV, slice * DV + DV) of head h.
template <int DV>
__global__ void __launch_bounds__(kThreads)
attention_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      int Tq, int Tk, int H, int D, Strides qs, Strides ks, Strides vs,
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

  FlashRows<DV> st;  // its qf is unused: Q comes in 64-column chunks
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tk, int H,
           Strides qs, Strides ks, Strides vs, float scale_log2, cudaStream_t stream) {
  constexpr int smem = 3 * (int)sizeof(TileD<D>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Tq + kTile - 1) / kTile, H, B);
  attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Tq, Tk, H, qs, ks,
      vs, scale_log2);
  return (int)cudaGetLastError();
}

template <int DV>
int launch_wide(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tk,
                int H, int D, Strides qs, Strides ks, Strides vs, float scale_log2,
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
// (unit stride over the last dim); out (B, Tq, H, D) bf16, contiguous.
// D must be a positive multiple of 64 (cudaErrorInvalidValue otherwise): 64
// and 128 take the one-pass kernel, the others the wide one. scale_log2 =
// D^-1/2 * log2(e) multiplies the fp32 logits (base-2 softmax).
extern "C" int pi3_attention(const void* q, const void* k, const void* v, void* out, int B, int Tq,
                             int Tk, int H, int D, long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh, long long v_sb,
                             long long v_st, long long v_sh, float scale_log2, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, B, Tq, Tk, H, qs, ks, vs, scale_log2, s);
    case 128:
      return launch<128>(q, k, v, out, B, Tq, Tk, H, qs, ks, vs, scale_log2, s);
    default:
      if (D <= 0 || D % 64) return (int)cudaErrorInvalidValue;
      if (D % 128 == 0)
        return launch_wide<128>(q, k, v, out, B, Tq, Tk, H, D, qs, ks, vs, scale_log2, s);
      return launch_wide<64>(q, k, v, out, B, Tq, Tk, H, D, qs, ks, vs, scale_log2, s);
  }
}
