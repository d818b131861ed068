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

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <math.h>

#include "mma.cuh"

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait of more than
// ~2^34 clocks (seconds; every real wait is microseconds) traps, so that a
// barrier fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 0xFFFFu) == 0) {
      if (start == 0) start = clock64();
      else if (clock64() - start > (1ll << 34)) __trap();
    }
  }
}

// One box (64 columns x 128 rows of batch row `batch`) -> dst, completion
// counted on bar in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

// --- wgmma

// Shared-memory matrix descriptor of a tile as TMA's 128-byte swizzle lays
// it out: rows of 128 bytes, 8-row groups 1024 bytes apart (stride byte
// offset), swizzle mode 1 (128B) in bits 62-63. The leading byte offset is
// not read by these layouts: a K-major k16 step (32 bytes) and the MN-major
// v tile's 64 columns (128 bytes) each lie inside one swizzled row.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous product that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128 fp32) = [d +] A (64 x 16, smem) . B^T (128 x 16, smem), both
// K-major. accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) . B (16 x 64, smem,
// MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S = Q K^T for the warpgroup's 64 query rows and one 128-key tile: 4 k-steps
// of 32 bytes along each 128-byte row.
__device__ __forceinline__ void issue_qk(float (&acc)[64], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_m64n128k16_ss(acc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
  wgmma_commit();
}

// O += P V: 8 k-steps of 16 keys, 16 rows of V (2048 bytes) each.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[8][4], uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs(o, p[kk], v_desc + kk * (2048 >> 4));
  wgmma_commit();
}

// Named barriers 1 and 2 order the two consumer warpgroups' products.
__device__ __forceinline__ void bar_sync(uint32_t id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// This thread's accumulator entries (any m64nN wgmma): rows r0 = 16 warp +
// lane/4 and r0 + 8 of the warpgroup's 64; entry 4i + e (e < 2) is row r0,
// column 8i + 2 t4 + e (t4 = lane % 4), entry 4i + 2 + e the same column of
// row r0 + 8. The four threads of a quad hold a row's columns.
struct Rows {
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw logits
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums
  float a0, a1;                          // rescale of O and l for the tile in flight
  float rs0, rs1;                        // its partial row sums
};

// Base-2 online softmax of one tile's raw logits (keys k0 .. k0+127; keys >=
// t_valid masked): updates the running max and turns acc into
// 2^(scale * (s - m)); the rescale of O waits for the product in flight.
// Key k0 < t_valid is in every tile, so the max stays finite.
__device__ __forceinline__ void softmax_tile(Rows& r, float (&acc)[64], int k0, int t_valid,
                                             int t4, float scale_log2) {
  if (k0 + kBlockN > t_valid) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + 8 * i + 2 * t4 + e >= t_valid) acc[4 * i + e] = acc[4 * i + 2 + e] = -INFINITY;
      }
    }
  }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mx0 = fmaxf(mx0, fmaxf(acc[4 * i], acc[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(acc[4 * i + 2], acc[4 * i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  r.a0 = ex2((r.m0 - mx0) * scale_log2);  // 0 on the first tile (m = -inf)
  r.a1 = ex2((r.m1 - mx1) * scale_log2);
  r.m0 = mx0;
  r.m1 = mx1;
  const float sub0 = mx0 * scale_log2;
  const float sub1 = mx1 * scale_log2;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    acc[4 * i] = ex2(fmaf(acc[4 * i], scale_log2, -sub0));
    acc[4 * i + 1] = ex2(fmaf(acc[4 * i + 1], scale_log2, -sub0));
    acc[4 * i + 2] = ex2(fmaf(acc[4 * i + 2], scale_log2, -sub1));
    acc[4 * i + 3] = ex2(fmaf(acc[4 * i + 3], scale_log2, -sub1));
    rs0 += acc[4 * i] + acc[4 * i + 1];
    rs1 += acc[4 * i + 2] + acc[4 * i + 3];
  }
  r.rs0 = rs0;
  r.rs1 = rs1;
}

// After the product in flight has finished: rescale O and the row sums, and
// round P to bf16 (keys 16kk .. 16kk+15 are accumulator columns 2kk, 2kk+1:
// the A-operand layout of k-step kk).
__device__ __forceinline__ void finish_tile(Rows& r, float (&o)[32], uint32_t (&p)[8][4],
                                            const float (&acc)[64]) {
  r.l0 = r.l0 * r.a0 + r.rs0;
  r.l1 = r.l1 * r.a1 + r.rs1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    o[4 * n] *= r.a0;
    o[4 * n + 1] *= r.a0;
    o[4 * n + 2] *= r.a1;
    o[4 * n + 3] *= r.a1;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    p[kk][0] = pack_float2(acc[8 * kk], acc[8 * kk + 1]);
    p[kk][1] = pack_float2(acc[8 * kk + 2], acc[8 * kk + 3]);
    p[kk][2] = pack_float2(acc[8 * kk + 4], acc[8 * kk + 5]);
    p[kk][3] = pack_float2(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
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
  softmax_tile(r, acc, 0, t_valid, t4, scale_log2);
  finish_tile(r, o, p, acc);

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
    softmax_tile(r, acc, j * kBlockN, t_valid, t4, scale_log2);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(&sm.empty[prev]);  // K and V of tile j-1 consumed
    finish_tile(r, o, p, acc);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// qkv: (B, T, 3*H*64) bf16, contiguous, 16-byte aligned; out: (B, t_valid,
// H*64) bf16. Keys and queries with index >= t_valid are ignored.
// scale_log2 > 0 multiplies the fp32 logits (base-2 softmax). Returns a
// cudaError_t: cudaErrorInvalidValue if the tensor map cannot be encoded.
extern "C" int pi3_packed_attention(const void* qkv, void* out, int B, int T, int H,
                                    int t_valid, float scale_log2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
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
