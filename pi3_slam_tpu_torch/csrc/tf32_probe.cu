// Two measurements behind the fp32 GEMM's design (gemm_f32.cuh), run by
// `python -m pi3_slam_tpu_torch.tools.perf_lab tf32`; no product path
// calls them:
//   pi3_tf32_probe: one wgmma m64n128k8 tf32 on raw fp32 tiles (64 x 32 of
//     A, 128 x 32 of W, TMA with 128-byte swizzle; k 0-7), the accumulator
//     written out as it is. With one-hot rows on one side the output is the
//     other side's elements as the tensor cores read them, which tells
//     whether they drop an fp32 pattern's low 13 bits or round it.
//   pi3_gemm_f32_depth: the GEMM with the kBias epilogue at a chosen group
//     depth (k8 steps a wgmma accumulator sums before the fp32 add).
//   pi3_attention_f32_depth: the fp32 attention loop at head dim 64
//     (bthd_attention_f32.cuh) at group depth 4 or 8.

#include "device_guard.cuh"
#include "bthd_attention_f32.cuh"
#include "gemm_f32.cuh"

using namespace pi3;

namespace {

struct __align__(1024) ProbeSmem {
  float a[64 * 32];
  float b[128 * 32];
  uint64_t bar;
};

__global__ void __launch_bounds__(128)
tf32_probe_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map, float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  ProbeSmem& sm = *reinterpret_cast<ProbeSmem*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));
  if (threadIdx.x == 0) {
    mbar_init(&sm.bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.bar, (64 + 128) * 32 * 4);
    tma_load(sm.a, &a_map, &sm.bar, 0, 0);
    tma_load(sm.b, &b_map, &sm.bar, 0, 0);
  }
  mbar_wait(&sm.bar, 0);
  float acc[64];
  wgmma_fence();
  wgmma_tf32_ss<128>(acc, smem_desc(sm.a), smem_desc(sm.b), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(16 * warp + g + 8 * (e >> 1)) * 128 + 8 * i + 2 * t4 + (e & 1)] = acc[4 * i + e];
}

}  // namespace

// a (64, 32), w (128, 32) fp32 row-major, 16-byte aligned; out (64, 128)
// fp32 = a[:, :8] . w[:, :8]^T in one tf32 wgmma. Returns a cudaError_t.
extern "C" int pi3_tf32_probe(const void* a, const void* w, void* out, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  CUtensorMap a_map, b_map;
  if (!encode_matrix_map(&a_map, a, 64, 32, 64, 4) || !encode_matrix_map(&b_map, w, 128, 32, 128, 4))
    return (int)cudaErrorInvalidValue;
  const int smem = sizeof(ProbeSmem) + 1024;
  tf32_probe_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(a_map, b_map, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// out (M, N) = A (M, K) . W (N, K)^T + bias through gemm_f32.cuh's loop with
// groups of g8 k8 steps (4, 8, 16 or 32; 0: all of K in one group).
extern "C" int pi3_gemm_f32_depth(const void* A, const void* W, const void* bias, void* out, int M,
                                  int N, int K, int g8, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  const auto* a = static_cast<const float*>(A);
  const auto* w = static_cast<const float*>(W);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (g8) {
    case 4: return launch_gemm_f32<kBias, 4>(a, w, b, nullptr, nullptr, o, M, N, K, s);
    case 8: return launch_gemm_f32<kBias, 8>(a, w, b, nullptr, nullptr, o, M, N, K, s);
    case 16: return launch_gemm_f32<kBias, 16>(a, w, b, nullptr, nullptr, o, M, N, K, s);
    case 32: return launch_gemm_f32<kBias, 32>(a, w, b, nullptr, nullptr, o, M, N, K, s);
    case 0: return launch_gemm_f32<kBias, 1 << 20>(a, w, b, nullptr, nullptr, o, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out (B, Tq, H, 64) = softmax_2(scale q.k^T) v over contiguous fp32 (B, Tq,
// H, 64) q and (B, Tk, H, 64) k / v through bthd_attention_f32.cuh's loop
// with groups of g8 k8 steps (4: the kernel's, or 8).
extern "C" int pi3_attention_f32_depth(const void* q, const void* k, const void* v, void* out,
                                       int B, int Tq, int Tk, int H, float scale, int g8,
                                       int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* o = static_cast<float*>(out);
  const BthdStrides qs{(long long)Tq * H * 64, H * 64, 64}, ks{(long long)Tk * H * 64, H * 64, 64};
  cudaStream_t s = (cudaStream_t)stream;
  switch (g8) {
    case 4:
      return launch_attention_f32_tma<kSoftmax, 4>(qp, kp, vp, o, nullptr, nullptr, B, Tq, Tk, H,
                                                   qs, ks, ks, scale, s);
    case 8:
      return launch_attention_f32_tma<kSoftmax, 8>(qp, kp, vp, o, nullptr, nullptr, B, Tq, Tk, H,
                                                   qs, ks, ks, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
