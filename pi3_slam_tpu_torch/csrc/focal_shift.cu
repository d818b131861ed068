// The focal / shift solve for Hopper (sm_90a): the fixed-iteration damped
// Gauss-Newton over each frame's scalar z-shift, batched over frames, in one
// launch (pi3_focal_shift).
//
// Replaces no Pallas kernel: on the TPU, XLA compiled the JAX solve
// (pi3_slam_tpu/geometry/focal.py::_solve_shift_single, a lax.scan of 30
// steps) into one program. Run eagerly (ops/focal_shift.solve_shift_plain)
// the same solve is ~5,600 small launches a call, which the host enqueues
// while the card idles; here it is one.
//
// Bound on the H100: neither bytes nor operations, but the chain of
// dependent block reductions. At (100, 4096) a call reads 6.6 MB and does
// ~1.75 GFLOP (ops/roofline.focal_shift_work, a division counted as one
// operation: 0.026 ms at the fp32 peak, 0.002 ms of bytes), but each
// of its 30 iterations is four reductions in sequence (the step's sums, its
// loss and derivatives, the trial's sums, the trial's loss), each waiting on
// the last. So the design keeps everything on chip and a reduction short:
//
// * One block of 512 threads a frame (the frames run side by side on the
//   SMs). Thread t holds the frame's points t, t + 512, ... (PER of them, up
//   to 16: M <= 8192) in registers, read once.
// * A reduction: each thread sums its points in order, a warp by an xor
//   butterfly (every lane ends with the same bits: IEEE addition commutes),
//   the 16 warp sums go through shared memory, and every thread adds them in
//   warp order. So every thread holds the same totals and computes the same
//   scalars (f, f', f'', the step, the accept rule, lambda): no scalar
//   state is shared and nothing goes back to the host. Two shared buffers
//   alternate, so one __syncthreads a reduction suffices. The order is fixed
//   and there are no atomics: two launches on the same input give the same
//   bits.
// * The same arithmetic as the plain solve, term for term: IEEE fp32 (the
//   library is built with -fmad=false, so no product is fused into a sum
//   that the plain solve rounds on its own; divisions correctly rounded),
//   the live mask |z + shift| >= 1e-12, the clamp of B at 1e-12 and its
//   derivative gate, h_safe, lambda from 1e-3 halved (floor 1e-6) on an
//   accepted step and quadrupled on a rejected one, the strict < test, all
//   iterations run, and a frame of weight sum < 2 gives focal 1, shift 0.
//   Only the order of each sum differs from the plain solve's.
// * The trial step needs its loss alone: the sums of A and B, then the
//   loss; the derivatives (A', A'', B', B'') come only with the step's sums.

#include "device_guard.cuh"
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 6;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-12f;

// The block's totals of v[0..N), the same bits in every thread.
struct Reducer {
  float (*buf)[kMaxSums][kWarps];  // two buffers, used in turn
  int turn = 0;

  template <int N>
  __device__ __forceinline__ void sum(float (&v)[N]) {
    static_assert(N <= kMaxSums, "too many sums");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float(&b)[kMaxSums][kWarps] = buf[turn];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int off = 16; off; off >>= 1) v[i] += __shfl_xor_sync(kFull, v[i], off);
      if (lane == 0) b[i][warp] = v[i];
    }
    // a buffer is written again two reductions later, after every thread
    // has passed the next reduction's barrier and so finished reading it
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = b[i][0];
#pragma unroll
      for (int j = 1; j < kWarps; ++j) s += b[i][j];
      v[i] = s;
    }
    turn ^= 1;
  }
};

// This thread's points of one frame.
template <int PER>
struct Points {
  float x[PER], y[PER], z[PER], w[PER], u[PER], v[PER];
  int n = 0;  // how many of the PER slots hold a point
};

// d = z + shift where |z + shift| >= 1e-12, else 1e-12; live says which.
__device__ __forceinline__ float denominator(float z, float shift, float& live) {
  const float d = z + shift;
  const bool on = fabsf(d) >= kTiny;  // false for NaN, as in the plain solve
  live = on ? 1.0f : 0.0f;
  return on ? d : kTiny;
}

// The first sums of an evaluation at `shift`: A = sum w a uv and
// B_raw = sum w a a (a = xy / d); with kDerivs also A' = sum w a' uv,
// A'' = sum w a'' uv, S' = sum w a a' and S'' = sum w (a' a' + a a'').
template <bool kDerivs, int PER>
__device__ __forceinline__ void first_sums(const Points<PER>& p, float shift,
                                           float (&s)[kDerivs ? 6 : 2]) {
#pragma unroll
  for (int i = 0; i < (kDerivs ? 6 : 2); ++i) s[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (k < p.n) {
      float live;
      const float d = denominator(p.z[k], shift, live);
      const float xy[2] = {p.x[k], p.y[k]}, uv[2] = {p.u[k], p.v[k]};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float a = xy[c] / d;
        const float wa = p.w[k] * a;
        s[0] += wa * uv[c];
        s[1] += wa * a;
        if constexpr (kDerivs) {
          const float a1 = -a / d * live;
          const float a2 = 2.0f * a / (d * d) * live;
          s[2] += p.w[k] * a1 * uv[c];
          s[3] += p.w[k] * a2 * uv[c];
          s[4] += wa * a1;
          s[5] += p.w[k] * (a1 * a1 + a * a2);
        }
      }
    }
  }
}

// f = A / max(B_raw, 1e-12) (B_raw NaN stays NaN, as torch's clamp_min).
__device__ __forceinline__ float clamped_b(float b_raw) { return b_raw < kTiny ? kTiny : b_raw; }

// The second sums at `shift` given f, f', f'': L = sum w^2 r r and, with
// kDerivs, G = sum w^2 r r' and H = sum w^2 (r' r' + r r'') (r = f a - uv).
template <bool kDerivs, int PER>
__device__ __forceinline__ void second_sums(const Points<PER>& p, float shift, float f, float f1,
                                            float f2, float (&s)[kDerivs ? 3 : 1]) {
#pragma unroll
  for (int i = 0; i < (kDerivs ? 3 : 1); ++i) s[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (k < p.n) {
      float live;
      const float d = denominator(p.z[k], shift, live);
      const float w2 = p.w[k] * p.w[k];
      const float xy[2] = {p.x[k], p.y[k]}, uv[2] = {p.u[k], p.v[k]};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float a = xy[c] / d;
        const float r = f * a - uv[c];
        s[0] += w2 * r * r;
        if constexpr (kDerivs) {
          const float a1 = -a / d * live;
          const float a2 = 2.0f * a / (d * d) * live;
          const float r1 = f1 * a + f * a1;
          const float r2 = f2 * a + 2.0f * f1 * a1 + f * a2;
          s[1] += w2 * r * r1;
          s[2] += w2 * (r1 * r1 + r * r2);
        }
      }
    }
  }
}

// The loss of one frame at `shift` (f from the first sums).
template <int PER>
__device__ __forceinline__ float trial_loss(const Points<PER>& p, float shift, Reducer& red) {
  float s1[2];
  first_sums<false>(p, shift, s1);
  red.sum(s1);
  const float f = s1[0] / clamped_b(s1[1]);
  float s2[1];
  second_sums<false>(p, shift, f, 0.0f, 0.0f, s2);
  red.sum(s2);
  return s2[0];
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
focal_shift_kernel(const float* __restrict__ points, const float* __restrict__ uv,
                   const float* __restrict__ weight, float* __restrict__ focal_out,
                   float* __restrict__ shift_out, int m, int iterations) {
  __shared__ float buf[2][kMaxSums][kWarps];
  Reducer red{buf};
  const int frame = blockIdx.x;
  const float* pts = points + static_cast<size_t>(frame) * m * 3;
  const float* wts = weight + static_cast<size_t>(frame) * m;

  Points<PER> p;
  float wsum[1] = {0.0f};
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < m) {
      p.x[k] = pts[3 * i], p.y[k] = pts[3 * i + 1], p.z[k] = pts[3 * i + 2];
      p.w[k] = wts[i];
      p.u[k] = uv[2 * i], p.v[k] = uv[2 * i + 1];
      wsum[0] += p.w[k];
      p.n = k + 1;
    }
  }
  red.sum(wsum);

  float shift = 0.0f, lam = 1e-3f;
  for (int it = 0; it < iterations; ++it) {
    // the step: loss, g and h at shift
    float s[6];
    first_sums<true>(p, shift, s);
    red.sum(s);
    const float A = s[0], A1 = s[2], A2 = s[3];
    const float b_live = s[1] >= kTiny ? 1.0f : 0.0f;  // max(B, 1e-12) is constant below
    const float B = clamped_b(s[1]);
    const float B1 = 2.0f * s[4] * b_live;
    const float B2 = 2.0f * s[5] * b_live;
    const float f = A / B;
    const float num1 = A1 * B - A * B1;
    const float f1 = num1 / (B * B);
    const float f2 = (A2 * B - A * B2) / (B * B) - 2.0f * B1 * num1 / (B * B * B);
    float lgh[3];
    second_sums<true>(p, shift, f, f1, f2, lgh);
    red.sum(lgh);
    const float loss = lgh[0], g = 2.0f * lgh[1], h = 2.0f * lgh[2];
    const float h_safe = fabsf(h) < kTiny ? kTiny : h;
    const float new_shift = shift - g / (h_safe + lam * fabsf(h_safe));
    // the trial: accepted only if its loss is strictly lower (NaN never is)
    const bool improved = trial_loss(p, new_shift, red) < loss;
    shift = improved ? new_shift : shift;
    const float half = lam * 0.5f;
    lam = improved ? (half < 1e-6f ? 1e-6f : half) : lam * 4.0f;
  }

  float s1[2];
  first_sums<false>(p, shift, s1);
  red.sum(s1);
  if (threadIdx.x == 0) {
    const bool valid = wsum[0] >= 2.0f;  // fewer than 2 valid pixels: degenerate
    focal_out[frame] = valid ? s1[0] / clamped_b(s1[1]) : 1.0f;
    shift_out[frame] = valid ? shift : 0.0f;
  }
}

template <int PER>
cudaError_t launch(const float* points, const float* uv, const float* weight, float* focal,
                   float* shift, int frames, int m, int iterations, cudaStream_t stream) {
  focal_shift_kernel<PER><<<frames, kThreads, 0, stream>>>(points, uv, weight, focal, shift, m,
                                                           iterations);
  return cudaGetLastError();
}

}  // namespace

// points (frames, m, 3), uv (m, 2), weight (frames, m): fp32, contiguous;
// focal and shift (frames,) fp32. 1 <= m <= 8192, frames >= 1.
extern "C" int pi3_focal_shift(const float* points, const float* uv, const float* weight,
                               float* focal, float* shift, int frames, int m, int iterations,
                               int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (frames < 1 || m < 1 || m > 16 * kThreads || iterations < 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto run = [&](auto per) {
    return (int)launch<decltype(per)::value>(points, uv, weight, focal, shift, frames, m,
                                             iterations, stream);
  };
  if (m <= kThreads) return run(std::integral_constant<int, 1>{});
  if (m <= 2 * kThreads) return run(std::integral_constant<int, 2>{});
  if (m <= 4 * kThreads) return run(std::integral_constant<int, 4>{});
  if (m <= 8 * kThreads) return run(std::integral_constant<int, 8>{});
  return run(std::integral_constant<int, 16>{});
}
