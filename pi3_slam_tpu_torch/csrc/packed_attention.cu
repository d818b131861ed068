// Packed-qkv attention for Hopper (sm_90a): TMA loads into a ring of shared
// memory, wgmma products, a producer warpgroup (one thread issues the loads)
// and two consumer warpgroups.
//
// Replaces two Pallas TPU kernels of pi3_slam_tpu/ops/pallas_attention.py:
//   flash_attention_packed_tpu        (_flash_packed_kernel, global blocks)
//   attention_single_pass_packed_tpu  (_single_pass_packed_kernel, frame,
//                                      encoder and head blocks)
// Both compute out = softmax_2(s * q.k^T) . v per head over the packed
// (B, T, 3*H*64) qkv-projection layout, writing (B, t, H*64): head h of
// q/k/v sits at columns h*64, C+h*64, 2C+h*64 with row stride 3C. On the TPU
// they differed by how much of T fit in VMEM; here one online-softmax loop
// over 128-key tiles serves both. The TPU kernels' Cauchy-Schwarz bound shift
// is replaced by an exact running max; keys and queries at index >= t_valid
// are ignored whatever those rows hold.
//
// Bound on the H100 (989 TFLOP/s bf16, ~3.9e12 exp2/s on the special-function
// units): two products of 2*64 flop per logit and one exp2 per logit weigh
// the same at head dim 64. At the global shape (1, 64300, 3072) the products
// (1.69e13 flop) take 17.12 ms and the 6.62e10 exp2 16.96 ms; the bytes (0.5
// GB) are negligible. So a loop that runs its softmax after its products
// cannot go below ~34 ms; only one that runs the exp2 of one tile while the
// tensor cores work on another can approach 17 ms.
//
// Design:
// * Loads. One 3D tensor map over the packed tensor, (3C columns, t_valid
//   rows, B) with 128-byte swizzle; a box is 64 columns (one head: 128
//   bytes) x 128 rows. Its row extent is t_valid, so rows >= t_valid come in
//   as zeros (never the padding rows or the next batch row). One producer
//   thread issues Q once per block and K, V per key tile into a ring of
//   kStages stages, each with a full and an empty mbarrier.
// * Products. Each consumer warpgroup owns 64 query rows (a block 128).
//   S = Q K^T is wgmma m64n128k16 with both operands in swizzled shared
//   memory (K rows are the K-major B operand), 4 k-steps over D 64. P is
//   rounded to bf16 in registers (the accumulator layout is the A-operand
//   layout, as mma.sync's is) and O += P V is wgmma m64n64k16 with A from
//   registers and V as the MN-major (transposed) B operand, 8 k-steps.
// * Softmax in fp32 registers on the S accumulators: keys >= t_valid masked
//   on the last tile, exact running max, exp2 as one FFMA and one MUFU.EX2
//   per logit, O rescaled, row sums reduced across the quad at the end.
// * Overlap of the exp2 with the products, two ways (FlashAttention-3's):
//   inside a warpgroup, S_j = Q K_j^T is issued together with O += P_{j-1}
//   V_{j-1}, and the softmax of S_j runs while the latter is on the tensor
//   cores; between the two warpgroups, named barriers make them take turns
//   at issuing products (ping-pong), so one's softmax runs while the
//   other's products do.
// * setmaxnreg: the producer warpgroup drops to 24 registers, the consumers
//   take 240 (S 64, P 32 and O 32 of them live at once).

#include "device_guard.cuh"
#include "hopper.cuh"

using namespace pi3;

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBlockM = 128;    // query rows per block: two consumer warpgroups of 64
constexpr int kBlockN = 128;    // keys per tile
constexpr int kStages = 3;      // K / V ring depth
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kTileBytes = kBlockN * kD * 2;  // one q, k or v tile: 128 rows of 128 bytes

struct __align__(1024) Smem {  // 128-byte swizzle wants 1024-byte aligned tiles
  __nv_bfloat16 q[kBlockM * kD];
  __nv_bfloat16 k[kStages][kBlockN * kD];
  __nv_bfloat16 v[kStages][kBlockN * kD];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + slack to align the dynamic base

// S = Q K^T for the warpgroup's 64 query rows and one 128-key tile: 4 k-steps
// of 32 bytes along each 128-byte row.
__device__ __forceinline__ void issue_qk(float (&acc)[64], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_ss<kBlockN>(acc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
  wgmma_commit();
}

// O += P V: 8 k-steps of 16 keys, 16 rows of V (2048 bytes) each.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[8][4], uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_rs<kD>(o, p[kk], v_desc + kk * (2048 >> 4));
  wgmma_commit();
}

// --- the kernel

__global__ void __launch_bounds__(kThreads, 1)
packed_attention_kernel(const __grid_constant__ CUtensorMap qkv_map,
                        __nv_bfloat16* __restrict__ out, int H, int t_valid, float scale_log2) {
  extern __shared__ __align__(128) uint8_t smem_raw[];  // aligned to 1024 below
  const uint32_t raw = smem_u32(smem_raw);
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));

  const int C = H * kD;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (t_valid + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kTileBytes);
      tma_load(sm.q, &qkv_map, &sm.q_full, h * kD, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_load(sm.k[s], &qkv_map, &sm.full[s], C + h * kD, j * kBlockN, b);
        tma_load(sm.v[s], &qkv_map, &sm.full[s], 2 * C + h * kD, j * kBlockN, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;  // consumer warpgroup: query rows q0 + 64c .. q0 + 64c + 63
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const uint64_t q_desc = smem_desc(sm.q + c * 64 * kD);
  // Ping-pong: warpgroup c issues its products after bar.sync on barrier 1 + c
  // and then lets the other one issue (bar.arrive on 2 - c), so one's softmax
  // runs while the tensor cores work on the other's products. Warpgroup 0
  // opens its own barrier for its first turn.
  const uint32_t my_bar = 1 + c;
  const uint32_t other_bar = 2 - c;

  float o[32];
  float acc[64];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  Rows r;

  mbar_wait(&sm.q_full, 0);
  if (c == 0) bar_arrive(my_bar);

  // Turn 0: S_0 alone. Turn j (1 <= j < n): S_j and O += P_{j-1} V_{j-1}
  // issued together; the softmax of S_j runs while P_{j-1} V_{j-1} is on the
  // tensor cores. Turn n: the last P V.
  mbar_wait(&sm.full[0], 0);
  bar_sync(my_bar);
  fence_regs(acc);
  wgmma_fence();
  issue_qk(acc, q_desc, smem_desc(sm.k[0]));
  bar_arrive(other_bar);
  wgmma_wait<0>();
  fence_regs(acc);
  softmax_tile<kBlockN>(r, acc, 0, t_valid, t4, scale_log2);
  finish_tile<kBlockN, kD>(r, o, p, acc);

  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int prev = (j - 1) % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    bar_sync(my_bar);
    fence_regs(acc);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_qk(acc, q_desc, smem_desc(sm.k[s]));
    issue_pv(o, p, smem_desc(sm.v[prev]));
    bar_arrive(other_bar);
    wgmma_wait<1>();  // S_j done; P_{j-1} V_{j-1} may still run
    fence_regs(acc);
    softmax_tile<kBlockN>(r, acc, j * kBlockN, t_valid, t4, scale_log2);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(&sm.empty[prev]);  // K and V of tile j-1 consumed
    finish_tile<kBlockN, kD>(r, o, p, acc);
  }

  const int last = (n_tiles - 1) % kStages;
  bar_sync(my_bar);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
  issue_pv(o, p, smem_desc(sm.v[last]));
  if (c == 0) bar_arrive(other_bar);  // warpgroup 1's last turn has no successor
  wgmma_wait<0>();
  fence_regs(o);
  if (lane == 0) mbar_arrive(&sm.empty[last]);

  float l0 = r.l0, l1 = r.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  const int row_a = q0 + 64 * c + 16 * warp + (lane >> 2);
  const int row_b = row_a + 8;
  __nv_bfloat16* oa = out + ((size_t)b * t_valid + row_a) * C + h * kD + 2 * t4;
  __nv_bfloat16* ob = oa + (size_t)8 * C;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (row_a < t_valid)
      *reinterpret_cast<uint32_t*>(oa + n * 8) = pack_float2(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (row_b < t_valid)
      *reinterpret_cast<uint32_t*>(ob + n * 8) = pack_float2(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
}

}  // namespace

// qkv: (B, T, 3*H*64) bf16, contiguous, 16-byte aligned; out: (B, t_valid,
// H*64) bf16. Keys and queries with index >= t_valid are ignored.
// scale_log2 > 0 multiplies the fp32 logits (base-2 softmax). Returns a
// cudaError_t: cudaErrorInvalidValue if the tensor map cannot be encoded.
extern "C" int pi3_packed_attention(const void* qkv, void* out, int B, int T, int H,
                                    int t_valid, float scale_log2, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t cols = 3ull * H * kD;
  const cuuint64_t dims[3] = {cols, (cuuint64_t)t_valid, (cuuint64_t)B};
  const cuuint64_t strides[2] = {cols * 2, (cuuint64_t)T * cols * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {kD, kBlockN, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(packed_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_valid + kBlockM - 1) / kBlockM, H, B);
  packed_attention_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      map, static_cast<__nv_bfloat16*>(out), H, t_valid, scale_log2);
  return (int)cudaGetLastError();
}
