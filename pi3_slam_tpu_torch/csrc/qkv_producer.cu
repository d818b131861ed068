// The fused qkv producer for Hopper (sm_90a): per-head qk-LayerNorm, RoPE2D,
// the softmax scale D^-1/2 * log2(e) on q, v copied, and rows in [T, out_t)
// zeroed, in one pass over the packed (B, T, 3*H*64) qkv projection.
//
// Replaces the Pallas TPU kernel pi3_slam_tpu/ops/pallas_producer.py::
// qkv_rope_producer_tpu (_producer_kernel). The TPU kernel took its 64-lane
// LayerNorm statistics with an averaging-matrix product and rotated with
// lane rolls; here both are warp shuffles.
//
// Bound on the H100: bytes. At (100, 643, 3072) and (1, 64300, 3072) the pass
// reads 395 MB of qkv and 33 MB of fp32 cos / sin tables and writes 395 MB:
// 0.246 ms at 3.35 TB/s. Its ~20 fp32 operations per element are far below
// the card's ~20 flop/byte fp32 ridge. So the design reads each byte once
// and keeps many bytes in flight:
//
// * One warp per token row. Warps walk contiguous runs of rows (a run per
//   warp, as many warps as fit on the card at once), and each issues all of
//   a row's 16-byte loads (q, k and v of up to 16 heads: 3 x 4 passes of 512
//   bytes) before any arithmetic. Rows >= T are never read; rows in
//   [T, out_t) are written as zeros.
// * Lanes: a pass covers four heads, lane 8g + j holding columns 8j .. 8j+7
//   of head 4p + g (eight bf16 in one 16-byte load). H that is not a
//   multiple of 4 masks the lanes of the last pass (H 5: C 320, H 6: C 384);
//   H > 16 adds a grid row (blockIdx.y) per 16 heads.
// * cos / sin: the row's 8 columns of this lane are loaded into registers
//   once per row and serve every head of q and k.
// * LayerNorm: mean and variance (two passes, fp32) by three __shfl_xor_sync
//   each over the 8 lanes of a head; eps from the caller; the thread's 8
//   norm weights and biases of q and of k stay in registers for all rows.
// * RoPE: the partner of column i is i ^ 16 (GPT-NeoX pairs within each
//   32-column half), held by lane j ^ 2 at the same slot: one
//   __shfl_xor_sync(..., 2) per element; the sign is - where i % 32 < 16.
// * kn (optional): each warp keeps the running max of the pre-rotation
//   |k|^2 of its heads in registers and, when its run moves to another batch
//   row or ends, does one atomicMax on the float's bits per head (the values
//   are >= 0, so the integer order is the float order). A max does not
//   depend on the order of its operands, so kn repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                // warps a block
constexpr int kPasses = 4;               // 512-byte passes per q / k / v region: 16 heads
constexpr int kSliceHeads = 4 * kPasses;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void unpack8(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the upper half of the fp32 with the same value
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]), pack2(x[6], x[7]));
}

__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// Sum over the 8 lanes of a head. The butterfly adds the same pairs in every
// lane, so all eight get the same bits.
__device__ __forceinline__ float head_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 4);
  return v;
}

// LayerNorm over a head's 64 columns, of which x holds this lane's 8.
__device__ __forceinline__ void layer_norm(float (&x)[8], const float (&w)[8], const float (&b)[8],
                                           float eps) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) s += x[e];
  const float mean = head_sum(s) * (1.f / 64.f);
  float v = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    x[e] -= mean;
    v += x[e] * x[e];
  }
  const float rstd = rsqrtf(head_sum(v) * (1.f / 64.f) + eps);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = x[e] * rstd * w[e] + b[e];
}

// (x cos + partner sin) scale; sn carries the sign of the partner term.
__device__ __forceinline__ uint4 rope(const float (&x)[8], const float (&cs)[8],
                                      const float (&sn)[8], float scale) {
  float y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float partner = __shfl_xor_sync(kFull, x[e], 2);
    y[e] = (x[e] * cs[e] + partner * sn[e]) * scale;
  }
  return pack8(y);
}

__device__ __forceinline__ void flush_kn(float* kn_sq, float (&kmax)[kPasses], int b, int H,
                                         int h0, int j) {
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int h = h0 + 4 * p;
    if (j == 0 && h < H && kmax[p] > 0.f)
      atomicMax(reinterpret_cast<int*>(kn_sq + (size_t)b * H + h), __float_as_int(kmax[p]));
    kmax[p] = 0.f;
  }
}

template <bool kNorm, bool kKn>
__global__ void __launch_bounds__(kWarps * 32)
qkv_producer_kernel(const uint4* __restrict__ qkv, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, const float* __restrict__ qw,
                    const float* __restrict__ qb, const float* __restrict__ kw,
                    const float* __restrict__ kb, uint4* __restrict__ out,
                    float* __restrict__ kn_sq, int T, int out_t, int H, long long n_rows,
                    long long rows_per_warp, float eps, float scale) {
  const int lane = threadIdx.x & 31;
  const int j = lane & 7;  // columns 8j .. 8j+7 of the lane's head
  const long long r0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows_per_warp;
  const long long r1 = min(r0 + rows_per_warp, n_rows);
  if (r0 >= r1) return;  // warp-uniform
  const int h0 = blockIdx.y * kSliceHeads + (lane >> 3);  // the lane's head in pass 0
  const long long region = (long long)H * 8;  // 16-byte chunks of q (of k, of v) in a row
  bool live[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) live[p] = h0 + 4 * p < H;

  float wq[8], bq[8], wk[8], bk[8];
  if (kNorm) {
    load8(wq, qw + 8 * j);
    load8(bq, qb + 8 * j);
    load8(wk, kw + 8 * j);
    load8(bk, kb + 8 * j);
  }
  const float sign = (j & 2) ? 1.f : -1.f;  // - for columns i % 32 < 16
  float kmax[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) kmax[p] = 0.f;
  int kn_row = (int)(r0 / out_t);  // the batch row whose maxima kmax holds

  for (long long r = r0; r < r1; ++r) {
    const int b = (int)(r / out_t);
    const int t = (int)(r - (long long)b * out_t);
    if (kKn && b != kn_row) {
      flush_kn(kn_sq, kmax, kn_row, H, h0, j);
      kn_row = b;
    }
    uint4* dst = out + r * 3 * region + h0 * 8 + j;  // pass p at + 32p
    if (t >= T) {
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int p = 0; p < kPasses; ++p)
          if (live[p]) dst[part * region + 32 * p] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const long long row = (long long)b * T + t;
    const uint4* src = qkv + row * 3 * region + h0 * 8 + j;
    uint4 raw[3][kPasses];
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int p = 0; p < kPasses; ++p)
        raw[part][p] = live[p] ? __ldcs(src + part * region + 32 * p) : make_uint4(0u, 0u, 0u, 0u);
    float cs[8], sn[8];
    load8(cs, cos_t + row * 64 + 8 * j);
    load8(sn, sin_t + row * 64 + 8 * j);
#pragma unroll
    for (int e = 0; e < 8; ++e) sn[e] *= sign;

#pragma unroll
    for (int p = 0; p < kPasses; ++p)
      if (live[p]) dst[2 * region + 32 * p] = raw[2][p];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      float x[8];
      unpack8(raw[0][p], x);
      if (kNorm) layer_norm(x, wq, bq, eps);
      const uint4 y = rope(x, cs, sn, scale);
      if (live[p]) dst[32 * p] = y;
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      float x[8];
      unpack8(raw[1][p], x);
      if (kNorm) layer_norm(x, wk, bk, eps);
      if (kKn) {
        float sq = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) sq += x[e] * x[e];
        kmax[p] = fmaxf(kmax[p], head_sum(sq));
      }
      const uint4 y = rope(x, cs, sn, 1.f);
      if (live[p]) dst[region + 32 * p] = y;
    }
  }
  if (kKn) flush_kn(kn_sq, kmax, kn_row, H, h0, j);
}

template <bool kNorm, bool kKn>
int launch(const void* qkv, const float* cos_t, const float* sin_t, const float* qw,
           const float* qb, const float* kw, const float* kb, void* out, float* kn_sq, int B,
           int T, int out_t, int H, float eps, float scale, int device, cudaStream_t stream) {
  const long long n_rows = (long long)B * out_t;
  if (n_rows == 0) return (int)cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qkv_producer_kernel<kNorm, kKn>,
                                                      kWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  // as many warps as are resident at once, each over one run of rows
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1) * kWarps;
  const long long rows_per_warp = (n_rows + resident - 1) / resident;
  const long long warps = (n_rows + rows_per_warp - 1) / rows_per_warp;
  dim3 grid((unsigned)((warps + kWarps - 1) / kWarps), (H + kSliceHeads - 1) / kSliceHeads);
  qkv_producer_kernel<kNorm, kKn><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const uint4*>(qkv), cos_t, sin_t, qw, qb, kw, kb, static_cast<uint4*>(out),
      kn_sq, T, out_t, H, n_rows, rows_per_warp, eps, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B, T, 3*H*64) bf16 contiguous; cos / sin (B, T, 64) fp32 contiguous;
// q / k norm weights and biases (64,) fp32, or all four null for no norm;
// out (B, out_t, 3*H*64) bf16 contiguous; kn_sq (B*H,) fp32, zeroed by the
// caller, receives the per-head max |k|^2 when kn_sq is not null. All bases
// 16-byte aligned. Returns a cudaError_t.
extern "C" int pi3_qkv_producer(const void* qkv, const void* cos_t, const void* sin_t,
                                const void* qw, const void* qb, const void* kw, const void* kb,
                                void* out, void* kn_sq, int B, int T, int out_t, int H, float eps,
                                float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || T < 0 || out_t < T) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const float* w[4] = {static_cast<const float*>(qw), static_cast<const float*>(qb),
                       static_cast<const float*>(kw), static_cast<const float*>(kb)};
  float* kn = static_cast<float*>(kn_sq);
  cudaStream_t st = (cudaStream_t)stream;
  const bool norm = qw != nullptr;
  if (norm && kn)
    return launch<true, true>(qkv, c, s, w[0], w[1], w[2], w[3], out, kn, B, T, out_t, H, eps,
                              scale, device, st);
  if (norm)
    return launch<true, false>(qkv, c, s, w[0], w[1], w[2], w[3], out, kn, B, T, out_t, H, eps,
                               scale, device, st);
  if (kn)
    return launch<false, true>(qkv, c, s, w[0], w[1], w[2], w[3], out, kn, B, T, out_t, H, eps,
                               scale, device, st);
  return launch<false, false>(qkv, c, s, w[0], w[1], w[2], w[3], out, kn, B, T, out_t, H, eps,
                              scale, device, st);
}
