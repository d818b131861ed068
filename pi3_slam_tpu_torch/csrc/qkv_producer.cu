// The fused qkv producer for Hopper (sm_90a): per-head qk-LayerNorm, RoPE2D,
// the softmax scale D^-1/2 * log2(e) on q, v copied, and rows in [T, out_t)
// zeroed, in one pass over the packed (B, T, 3*H*64) qkv projection.
//
// Replaces the Pallas TPU kernel pi3_slam_tpu/ops/pallas_producer.py::
// qkv_rope_producer_tpu (_producer_kernel), in bf16 (pi3_qkv_producer) and in
// fp32 (pi3_qkv_producer_f32: an fp32 model's rows, all arithmetic fp32 as
// in bf16, fp32 out). The TPU kernel took its 64-lane LayerNorm statistics
// with an averaging-matrix product and rotated with lane rolls; here both
// are warp shuffles.
//
// Bound on the H100: bytes. At (100, 643, 3072) and (1, 64300, 3072) the pass
// reads 395 MB of qkv and 33 MB of fp32 cos / sin tables and writes 395 MB:
// 0.246 ms at 3.35 TB/s (fp32 rows: 790 MB each way, 0.482 ms). Its ~20 fp32 operations per element are far below
// the card's ~20 flop/byte fp32 ridge. So the design reads each byte once
// and keeps many bytes in flight:
//
// * One warp per token row. Warps walk contiguous runs of rows (a run per
//   warp, as many warps as fit on the card at once), and each issues all of
//   a row's 16-byte loads (q, k and v of up to 16 heads: 3 x 4 passes of 512
//   bytes) before any arithmetic. Rows >= T are never read; rows in
//   [T, out_t) are written as zeros.
// * Lanes: a lane loads 16 bytes, E columns (8 bf16 or 4 fp32), so a head
//   takes L = 64 / E lanes (8 or 16) and a pass of the warp 32 / L heads (4
//   or 2): lane Lg + j holds columns Ej .. Ej+E-1 of head (32 / L) p + g.
//   H that is not a multiple of a pass masks the lanes of the last pass (H
//   5: C 320, H 6: C 384); more heads than four passes hold add a grid row
//   (blockIdx.y) per slice of 4 passes (16 heads in bf16, 8 in fp32).
// * cos / sin: the row's E columns of this lane are loaded into registers
//   once per row and serve every head of q and k.
// * LayerNorm: mean and variance (two passes, fp32) by log2(L)
//   __shfl_xor_sync each over the L lanes of a head; eps from the caller;
//   the thread's E norm weights and biases of q and of k stay in registers
//   for all rows.
// * RoPE: the partner of column i is i ^ 16 (GPT-NeoX pairs within each
//   32-column half), held by lane j ^ (16 / E) at the same slot (j ^ 2 in
//   bf16, j ^ 4 in fp32): one __shfl_xor_sync per element; the sign is -
//   where i % 32 < 16.
// * kn (optional): each warp keeps the running max of the pre-rotation
//   |k|^2 of its heads in registers and, when its run moves to another batch
//   row or ends, does one atomicMax on the float's bits per head (the values
//   are >= 0, so the integer order is the float order). A max does not
//   depend on the order of its operands, so kn repeats bit for bit.

#include "device_guard.cuh"
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // warps a block
constexpr int kPasses = 4;  // 512-byte passes per q / k / v region and slice
constexpr unsigned kFull = 0xffffffffu;

// The lane layout of one element type (see the header).
template <typename Elem>
struct Lanes {
  static constexpr int E = 16 / sizeof(Elem);   // columns a lane
  static constexpr int L = 64 / E;           // lanes a head
  static constexpr int kPassHeads = 32 / L;  // heads a warp pass
  static constexpr int kSliceHeads = kPassHeads * kPasses;
  static constexpr int kPartner = 16 / E;    // lane xor of the rotation partner
};

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the upper half of the fp32 with the same value
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x), x[1] = __uint_as_float(u.y), x[2] = __uint_as_float(u.z),
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack(const float (&x)[8]) {
  return make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]), pack2(x[6], x[7]));
}

__device__ __forceinline__ uint4 pack(const float (&x)[4]) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                    __float_as_uint(x[3]));
}

template <int E>
__device__ __forceinline__ void load_f32(float (&x)[E], const float* p) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p) + i);
    x[4 * i] = a.x, x[4 * i + 1] = a.y, x[4 * i + 2] = a.z, x[4 * i + 3] = a.w;
  }
}

// Sum over the L lanes of a head. The butterfly adds the same pairs in every
// lane, so all of them get the same bits.
template <int L>
__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// LayerNorm over a head's 64 columns, of which x holds this lane's E.
template <int E>
__device__ __forceinline__ void layer_norm(float (&x)[E], const float (&w)[E], const float (&b)[E],
                                           float eps) {
  constexpr int L = 64 / E;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s += x[e];
  const float mean = head_sum<L>(s) * (1.f / 64.f);
  float v = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    x[e] -= mean;
    v += x[e] * x[e];
  }
  const float rstd = rsqrtf(head_sum<L>(v) * (1.f / 64.f) + eps);
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = x[e] * rstd * w[e] + b[e];
}

// (x cos + partner sin) scale; sn carries the sign of the partner term.
template <int E>
__device__ __forceinline__ uint4 rope(const float (&x)[E], const float (&cs)[E],
                                      const float (&sn)[E], float scale) {
  float y[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float partner = __shfl_xor_sync(kFull, x[e], 16 / E);
    y[e] = (x[e] * cs[e] + partner * sn[e]) * scale;
  }
  return pack(y);
}

template <int kPassHeads>
__device__ __forceinline__ void flush_kn(float* kn_sq, float (&kmax)[kPasses], int b, int H,
                                         int h0, int j) {
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int h = h0 + kPassHeads * p;
    if (j == 0 && h < H && kmax[p] > 0.f)
      atomicMax(reinterpret_cast<int*>(kn_sq + (size_t)b * H + h), __float_as_int(kmax[p]));
    kmax[p] = 0.f;
  }
}

template <typename Elem, bool kNorm, bool kKn>
__global__ void __launch_bounds__(kWarps * 32)
qkv_producer_kernel(const uint4* __restrict__ qkv, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, const float* __restrict__ qw,
                    const float* __restrict__ qb, const float* __restrict__ kw,
                    const float* __restrict__ kb, uint4* __restrict__ out,
                    float* __restrict__ kn_sq, int T, int out_t, int H, long long n_rows,
                    long long rows_per_warp, float eps, float scale) {
  using LT = Lanes<Elem>;
  constexpr int E = LT::E;
  constexpr int L = LT::L;
  const int lane = threadIdx.x & 31;
  const int j = lane % L;  // columns Ej .. Ej+E-1 of the lane's head
  const long long r0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows_per_warp;
  const long long r1 = min(r0 + rows_per_warp, n_rows);
  if (r0 >= r1) return;  // warp-uniform
  const int h0 = blockIdx.y * LT::kSliceHeads + lane / L;  // the lane's head in pass 0
  const long long region = (long long)H * L;  // 16-byte chunks of q (of k, of v) in a row
  bool live[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) live[p] = h0 + LT::kPassHeads * p < H;

  float wq[E], bq[E], wk[E], bk[E];
  if (kNorm) {
    load_f32<E>(wq, qw + E * j);
    load_f32<E>(bq, qb + E * j);
    load_f32<E>(wk, kw + E * j);
    load_f32<E>(bk, kb + E * j);
  }
  const float sign = (j & LT::kPartner) ? 1.f : -1.f;  // - for columns i % 32 < 16
  float kmax[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) kmax[p] = 0.f;
  int kn_row = (int)(r0 / out_t);  // the batch row whose maxima kmax holds

  for (long long r = r0; r < r1; ++r) {
    const int b = (int)(r / out_t);
    const int t = (int)(r - (long long)b * out_t);
    if (kKn && b != kn_row) {
      flush_kn<LT::kPassHeads>(kn_sq, kmax, kn_row, H, h0, j);
      kn_row = b;
    }
    uint4* dst = out + r * 3 * region + h0 * L + j;  // pass p at + 32p
    if (t >= T) {
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int p = 0; p < kPasses; ++p)
          if (live[p]) dst[part * region + 32 * p] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const long long row = (long long)b * T + t;
    const uint4* src = qkv + row * 3 * region + h0 * L + j;
    uint4 raw[3][kPasses];
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int p = 0; p < kPasses; ++p)
        raw[part][p] = live[p] ? __ldcs(src + part * region + 32 * p) : make_uint4(0u, 0u, 0u, 0u);
    float cs[E], sn[E];
    load_f32<E>(cs, cos_t + row * 64 + E * j);
    load_f32<E>(sn, sin_t + row * 64 + E * j);
#pragma unroll
    for (int e = 0; e < E; ++e) sn[e] *= sign;

#pragma unroll
    for (int p = 0; p < kPasses; ++p)
      if (live[p]) dst[2 * region + 32 * p] = raw[2][p];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      float x[E];
      unpack(raw[0][p], x);
      if (kNorm) layer_norm<E>(x, wq, bq, eps);
      const uint4 y = rope<E>(x, cs, sn, scale);
      if (live[p]) dst[32 * p] = y;
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      float x[E];
      unpack(raw[1][p], x);
      if (kNorm) layer_norm<E>(x, wk, bk, eps);
      if (kKn) {
        float sq = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) sq += x[e] * x[e];
        kmax[p] = fmaxf(kmax[p], head_sum<L>(sq));
      }
      const uint4 y = rope<E>(x, cs, sn, 1.f);
      if (live[p]) dst[region + 32 * p] = y;
    }
  }
  if (kKn) flush_kn<LT::kPassHeads>(kn_sq, kmax, kn_row, H, h0, j);
}

template <typename Elem, bool kNorm, bool kKn>
int launch(const void* qkv, const float* cos_t, const float* sin_t, const float* qw,
           const float* qb, const float* kw, const float* kb, void* out, float* kn_sq, int B,
           int T, int out_t, int H, float eps, float scale, int device, cudaStream_t stream) {
  const long long n_rows = (long long)B * out_t;
  if (n_rows == 0) return (int)cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qkv_producer_kernel<Elem, kNorm, kKn>,
                                                      kWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  // as many warps as are resident at once, each over one run of rows
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1) * kWarps;
  const long long rows_per_warp = (n_rows + resident - 1) / resident;
  const long long warps = (n_rows + rows_per_warp - 1) / rows_per_warp;
  constexpr int kSlice = Lanes<Elem>::kSliceHeads;
  dim3 grid((unsigned)((warps + kWarps - 1) / kWarps), (H + kSlice - 1) / kSlice);
  qkv_producer_kernel<Elem, kNorm, kKn><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const uint4*>(qkv), cos_t, sin_t, qw, qb, kw, kb, static_cast<uint4*>(out),
      kn_sq, T, out_t, H, n_rows, rows_per_warp, eps, scale);
  return (int)cudaGetLastError();
}

template <typename Elem>
int produce(const void* qkv, const void* cos_t, const void* sin_t, const void* qw, const void* qb,
            const void* kw, const void* kb, void* out, void* kn_sq, int B, int T, int out_t, int H,
            float eps, float scale, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
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
    return launch<Elem, true, true>(qkv, c, s, w[0], w[1], w[2], w[3], out, kn, B, T, out_t, H, eps,
                                 scale, device, st);
  if (norm)
    return launch<Elem, true, false>(qkv, c, s, w[0], w[1], w[2], w[3], out, kn, B, T, out_t, H, eps,
                                  scale, device, st);
  if (kn)
    return launch<Elem, false, true>(qkv, c, s, w[0], w[1], w[2], w[3], out, kn, B, T, out_t, H, eps,
                                  scale, device, st);
  return launch<Elem, false, false>(qkv, c, s, w[0], w[1], w[2], w[3], out, kn, B, T, out_t, H, eps,
                                 scale, device, st);
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
  return produce<__nv_bfloat16>(qkv, cos_t, sin_t, qw, qb, kw, kb, out, kn_sq, B, T, out_t, H, eps,
                                scale, device, stream);
}

// The same with qkv and out fp32.
extern "C" int pi3_qkv_producer_f32(const void* qkv, const void* cos_t, const void* sin_t,
                                    const void* qw, const void* qb, const void* kw,
                                    const void* kb, void* out, void* kn_sq, int B, int T,
                                    int out_t, int H, float eps, float scale, int device,
                                    void* stream) {
  return produce<float>(qkv, cos_t, sin_t, qw, qb, kw, kb, out, kn_sq, B, T, out_t, H, eps, scale,
                        device, stream);
}
