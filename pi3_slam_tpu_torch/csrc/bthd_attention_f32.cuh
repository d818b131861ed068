// The fp32 attention loop for Hopper (sm_90a), TMA + wgmma tf32 with the
// 3xTF32 split: every fp32 attention launch of attention_f32.cu. Head dim 64
// (pi3_attention_f32 at D 64: the packed projection's q / k / v views and
// (B, T, H, 64) tensors, and pi3_partial_attention_f32) runs the loop below;
// every wider head dim its sliced variant at the end of this file.
// Per (batch, head), in fp32 throughout (P is kept in fp32):
//   s = scale * q.k^T (base 2), keys >= Tk masked, out = softmax_2(s) . v
// normalised (kSoftmax), or acc = sum_j 2^(s_j - mh) v_j and l = sum_j
// 2^(s_j - mh) with mh = min(|q| scale kn + 1, 120) (kPartialSums; see
// partial_attention.cu for the contract). The scale multiplies the logits
// before the running max, so any scale (0 and negative ones too) is taken as
// it is.
//
// Design: bthd_attention.cuh's loop (a TMA producer, an mbarrier ring, two
// consumer warpgroups of 64 query rows) with gemm_f32.cuh's split:
// * Loads. q, k and v each get a 4D fp32 tensor map (64 columns, H heads, T
//   rows, B) over their own strides, 128-byte swizzle: a box is 32 columns
//   (one 128-byte row of fp32), a 64-wide tile two boxes. The row extent is
//   Tq for q and Tk for k and v: rows past it come in zero-filled, so NaN
//   behind the last row never loads. One producer thread issues Q (128
//   rows) once a block, then K and V per 64-key tile into a ring of two
//   stages with full and empty mbarriers.
// * The split, once per element. x = big + small, big = x's raw pattern (the
//   tensor cores drop its low 13 bits: PERF.md's probe), small = tf32_small(x).
//   Q: each consumer thread loads its wgmma A fragments once (64 registers,
//   big and small). K and V: the producer warpgroup's warps 1-3 write each
//   landed stage's K small parts, and V transposed (both parts), then
//   arrive on the stage's ready barrier after a proxy fence.
// * Why V is transposed. wgmma takes tf32 operands from shared memory only
//   K-major (the transpose immediates are f16 / bf16 only), and O += P V
//   contracts over keys while V lands contiguous along D. So the split
//   warps write V^T (64 D-rows x 64 keys, two 32-key boxes, 128-byte
//   swizzled as the descriptor reads them). They fold P's layout into it:
//   a thread's S accumulators hold keys 2t and 2t+1 of each 8-key group, and
//   the tf32 A registers want k t and t+4, so V^T's column 8i + t holds key
//   8i + 2t and column 8i + t + 4 key 8i + 2t + 1 (vt_column). P then goes
//   from the S accumulators into wgmma_tf32_rs with no shuffles.
// * Products. Per k8 step three wgmma m64n64k8 tf32 with A from registers,
//   small.big', big.small', big.big' (the small terms first): S = Q K^T (Q's
//   fragments, K's two parts; Q from shared memory measured 10-15% slower), O_tile = P V (P's raw accumulators and their
//   small parts rounded in registers, V^T's two parts). The tensor cores
//   truncate when they accumulate, so no product sums across key tiles: each
//   group of kF32AttnGroupK8 = 4 k8 steps goes into an accumulator with
//   scale-d 0 on its first step and is added in fp32, S's second group to
//   its first, each group of O_tile to the running O (rescaled by the online
//   softmax first). Groups of 4 against 8 (a whole product): relative L2
//   1.1e-6 against 1.5e-6 at the global shape, at equal time (PERF.md).
// * Softmax: the logits scaled, then hopper.cuh's base-2 online softmax on
//   the accumulators (exact running max, keys >= Tk masked to -inf first).
//   The two consumer warpgroups run unsynchronised: one's softmax and fp32
//   adds run under the other's products. Taking turns at the tensor cores
//   (named barriers) and issuing S_j with P_{j-1} V_{j-1} (FlashAttention-3's
//   overlap) both measured slower (PERF.md): the latter frees a stage one
//   tile later, and a third 80 KB stage does not fit.
// * No split-K over keys and no atomics: two calls give the same bits.
//
// Budgets: shared memory Q 32 KB + two stages of 80 KB (K, K small, V, V^T
// big and small, 16 KB each) = 192 KB + barriers (static_assert below);
// registers (setmaxnreg: 232 a consumer thread, 40 a producer one): Q's
// fragments 64, S, the group accumulator, O, P's big and small parts 32
// each, at most 224 live; ptxas reports no spills (PERF.md).
//
// Bound on the H100: operations, 4 Tq Tk 64 per (batch, head) over 3xTF32's
// 165 TFLOP/s (a third of TF32's 495).
#pragma once

#include "bthd_attention.cuh"

namespace pi3 {

constexpr int kF32AttnRows = 128;    // query rows a block: two consumer warpgroups of 64
constexpr int kF32AttnThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kF32AttnN = 64;         // keys a tile
constexpr int kF32AttnStages = 2;
constexpr int kF32AttnGroupK8 = 4;    // k8 steps one wgmma accumulator sums (PERF.md)
constexpr int kF32AttnSplitThreads = 96;  // the producer warpgroup's warps 1-3
constexpr int kF32AttnBox = kF32AttnN * 32;  // floats of a 64-row box (32 columns)

struct __align__(1024) F32AttnSmem {
  float q[2][kF32AttnRows * 32];                    // Q's boxes: columns 0-31, 32-63
  float k[kF32AttnStages][2][kF32AttnBox];          // K as landed (its big part)
  float k_small[kF32AttnStages][2][kF32AttnBox];    // K's small parts, same layout
  float v[kF32AttnStages][2][kF32AttnBox];          // V as landed
  float vt[kF32AttnStages][2][kF32AttnBox];         // V^T: box b keys 32b.. x 64 D-rows
  float vt_small[kF32AttnStages][2][kF32AttnBox];
  uint64_t q_full;
  uint64_t full[kF32AttnStages];   // the stage's K and V landed
  uint64_t ready[kF32AttnStages];  // its K small parts and V^T written
  uint64_t empty[kF32AttnStages];  // its products done
};

constexpr int kF32AttnSmemBytes = sizeof(F32AttnSmem) + 1024;  // + slack to align the base
static_assert(kF32AttnSmemBytes <= 232448,
              "the fp32 attention's tiles exceed 227 KB of shared memory");

// V^T's column of key `key` within its 8-key group's columns: key 8i + 2t + e
// at column 8i + t + 4e (the tf32 A-register order of P).
__device__ __forceinline__ int vt_column(int key) {
  return (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
}

// Warps 1-3 of the producer warpgroup (sid 0..95): each landed stage's K
// small parts and V^T's two parts.
__device__ __forceinline__ void f32_attention_split(F32AttnSmem& sm, int n_tiles, int sid) {
  const int warp = sid >> 5;
  const int lane = sid & 31;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kF32AttnStages;
    mbar_wait(&sm.full[s], (j / kF32AttnStages) & 1);
    const float4* k = reinterpret_cast<const float4*>(sm.k[s]);
    float4* ks = reinterpret_cast<float4*>(sm.k_small[s]);
    for (int i = sid; i < 2 * kF32AttnBox / 4; i += kF32AttnSplitThreads) {
      const float4 y = k[i];
      ks[i] = make_float4(tf32_small(y.x), tf32_small(y.y), tf32_small(y.z), tf32_small(y.w));
    }
    // unit u: keys 32 half .. (a lane each) x columns 4 dc .. 4 dc + 3 of V;
    // a 16-byte chunk c of row r sits at chunk c ^ (r % 8) in both layouts
    for (int u = warp; u < 32; u += kF32AttnSplitThreads / 32) {
      const int half = u >> 4;
      const int dc = u & 15;
      const int key = 32 * half + lane;
      const float4 x = *reinterpret_cast<const float4*>(
          sm.v[s][dc >> 3] + key * 32 + (((dc & 7) ^ (key & 7)) << 2));
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const int col = vt_column(key) & 31;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * dc + e;
        const int off = d * 32 + ((((col >> 2) ^ (d & 7)) << 2) | (col & 3));
        sm.vt[s][half][off] = xs[e];
        sm.vt_small[s][half][off] = tf32_small(xs[e]);
      }
    }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.ready[s]);
  }
}

// d = the k8 steps [k0, k0 + G) of A (registers: big ab, small as, per step
// the tf32 A layout) . B^T (two 64-row boxes of 32 columns, big bb and small
// bs descriptors) with scale-d 0 on the first, as one commit group.
template <int G>
__device__ __forceinline__ void f32_attention_products(float (&d)[32], const uint32_t (&ab)[8][4],
                                                       const uint32_t (&as)[8][4], uint64_t bb,
                                                       uint64_t bs, int k0) {
#pragma unroll
  for (int kk = k0; kk < k0 + G; ++kk) {
    // in 16-byte units: a box is 64 rows of 128 bytes, a k8 step 32 bytes
    const int off = (kk >> 2) * (kF32AttnBox * 4 / 16) + 2 * (kk & 3);
    wgmma_tf32_rs<64>(d, as[kk], bb + off, kk == k0 ? 0 : 1);
    wgmma_tf32_rs<64>(d, ab[kk], bs + off, 1);
    wgmma_tf32_rs<64>(d, ab[kk], bb + off, 1);
  }
  wgmma_commit();
}

// P in the A order of k8 step i (k t <-> key 8i + 2t, k t + 4 <-> key 8i +
// 2t + 1) from the accumulators: big the raw pattern, small rounded.
__device__ __forceinline__ void f32_attention_split_p(uint32_t (&pb)[8][4], uint32_t (&ps)[8][4],
                                                      const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float p4[4] = {s[4 * i], s[4 * i + 2], s[4 * i + 1], s[4 * i + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pb[i][e] = __float_as_uint(p4[e]);
      ps[i][e] = __float_as_uint(tf32_small(p4[e]));
    }
  }
}

// One block: 128 query rows of one (batch, head) (the design in the header);
// G: k8 steps an accumulator group sums (4, or 8: a whole product, for
// tf32_probe.cu's accuracy measurement).
template <int kMode, int G>
__global__ void __launch_bounds__(kF32AttnThreads, 1)
attention_f32_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, float* __restrict__ out,
                         const float* __restrict__ kn, float* __restrict__ lsum, int Tq, int Tk,
                         int H, float scale) {
  static_assert(G == 4 || G == 8, "a group is half or all of a product's 8 k8 steps");
  constexpr int N = kF32AttnN;
  constexpr int S = kF32AttnStages;
  extern __shared__ __align__(128) uint8_t smem_raw[];  // aligned to 1024 below
  const uint32_t raw = smem_u32(smem_raw);
  F32AttnSmem& sm = *reinterpret_cast<F32AttnSmem*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));

  const int q0 = blockIdx.x * kF32AttnRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (Tk + N - 1) / N;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.ready[s], kF32AttnSplitThreads / 32);  // one arrival per split warp
      mbar_init(&sm.empty[s], 8);                           // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer warpgroup: warp 0 loads, warps 1-3 split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kF32AttnRows * 64 * 4);
      tma_load(sm.q[0], &q_map, &sm.q_full, 0, h, q0, b);
      tma_load(sm.q[1], &q_map, &sm.q_full, 32, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        mbar_wait(&sm.empty[s], ((j / S) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(&sm.full[s], 2 * N * 64 * 4);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tma_load(sm.k[s][c], &k_map, &sm.full[s], 32 * c, h, j * N, b);
          tma_load(sm.v[s][c], &v_map, &sm.full[s], 32 * c, h, j * N, b);
        }
      }
    } else if (threadIdx.x >= 32) {
      f32_attention_split(sm, n_tiles, threadIdx.x - 32);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;  // consumer warpgroup: query rows q0 + 64c .. q0 + 64c + 63
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // Q's A fragments of k8 step kk: rows r and r + 8 (r % 8 = g), columns 8kk
  // + t4 and 8kk + t4 + 4, i.e. 16-byte chunks 2(kk % 4) and 2(kk % 4) + 1 of
  // box kk / 4's swizzled rows (chunk j of row r at j ^ (r % 8))
  mbar_wait(&sm.q_full, 0);
  uint32_t qb[8][4], qs[8][4];
  {
    const uint8_t* rows = reinterpret_cast<const uint8_t*>(sm.q[0]) +
                          (64 * c + 16 * warp + g) * 128 + t4 * 4;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = *reinterpret_cast<const float*>(
            rows + (kk >> 2) * (kF32AttnRows * 128) + (e & 1) * 8 * 128 +
            (((2 * (kk & 3) + (e >> 1)) ^ g) << 4));
        qb[kk][e] = __float_as_uint(x);
        qs[kk][e] = __float_as_uint(tf32_small(x));
      }
    }
  }

  float o[32], s[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  Rows r;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % S;
    const uint32_t phase = (j / S) & 1;
    mbar_wait(&sm.full[st], phase);
    mbar_wait(&sm.ready[st], phase);

    // S = Q K^T in groups of G k8 steps, each added in fp32
    const uint64_t kb = smem_desc(sm.k[st][0]);
    const uint64_t ks = smem_desc(sm.k_small[st][0]);
    fence_regs(s);
    fence_regs(qb);
    fence_regs(qs);
    wgmma_fence();
    f32_attention_products<G>(s, qb, qs, kb, ks, 0);
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int k0 = G; k0 < 8; k0 += G) {
      fence_regs(part);
      wgmma_fence();
      f32_attention_products<G>(part, qb, qs, kb, ks, k0);
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += part[i];
    }

    // the online softmax on the scaled logits: s becomes P; O and l rescaled
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale;
    softmax_tile<N>(r, s, j * N, Tk, t4, 1.f);
    r.l0 = r.l0 * r.a0 + r.rs0;
    r.l1 = r.l1 * r.a1 + r.rs1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[4 * n] *= r.a0;
      o[4 * n + 1] *= r.a0;
      o[4 * n + 2] *= r.a1;
      o[4 * n + 3] *= r.a1;
    }

    uint32_t pb[8][4], ps[8][4];
    f32_attention_split_p(pb, ps, s);

    // O += P V in groups of G k8 steps, each added in fp32
    const uint64_t vb = smem_desc(sm.vt[st][0]);
    const uint64_t vs = smem_desc(sm.vt_small[st][0]);
#pragma unroll
    for (int k0 = 0; k0 < 8; k0 += G) {
      fence_regs(part);
      fence_regs(pb);
      fence_regs(ps);
      wgmma_fence();
      f32_attention_products<G>(part, pb, ps, vb, vs, k0);
      wgmma_wait<0>();
      fence_regs(part);
      fence_regs(pb);
      fence_regs(ps);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] += part[i];
    }
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // K, V and V^T of tile j consumed
  }

  float l0 = r.l0, l1 = r.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row_a = q0 + 64 * c + 16 * warp + g;
  const int row_b = row_a + 8;
  const size_t ra = ((size_t)b * Tq + row_a) * H + h;  // (b, row, h) of (B, Tq, H)
  const size_t rb = ra + (size_t)8 * H;
  float f0, f1;
  if constexpr (kMode == kPartialSums) {
    // |q|^2 of rows r and r + 8 from the fragments: a thread holds 16 of a
    // row's 64 columns, the quad all of them
    float qq0 = 0.f, qq1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float a = __uint_as_float(qb[kk][0]), a2 = __uint_as_float(qb[kk][2]);
      const float bq = __uint_as_float(qb[kk][1]), b2 = __uint_as_float(qb[kk][3]);
      qq0 += a * a + a2 * a2;
      qq1 += bq * bq + b2 * b2;
    }
    qq0 += __shfl_xor_sync(0xffffffffu, qq0, 1);
    qq0 += __shfl_xor_sync(0xffffffffu, qq0, 2);
    qq1 += __shfl_xor_sync(0xffffffffu, qq1, 1);
    qq1 += __shfl_xor_sync(0xffffffffu, qq1, 2);
    const float knh = kn[b * H + h];
    const float mh0 = fminf(sqrtf(qq0) * scale * knh + 1.f, 120.f);
    const float mh1 = fminf(sqrtf(qq1) * scale * knh + 1.f, 120.f);
    // from the running max to the fixed shift (m <= mh - 1 unless the clamp binds)
    f0 = exp2f(r.m0 - mh0);
    f1 = exp2f(r.m1 - mh1);
    if (t4 == 0) {
      if (row_a < Tq) lsum[ra] = l0 * f0;
      if (row_b < Tq) lsum[rb] = l1 * f1;
    }
  } else {
    f0 = 1.f / l0;
    f1 = 1.f / l1;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (row_a < Tq)
      *reinterpret_cast<float2*>(out + ra * 64 + 8 * n + 2 * t4) =
          make_float2(o[4 * n] * f0, o[4 * n + 1] * f0);
    if (row_b < Tq)
      *reinterpret_cast<float2*>(out + rb * 64 + 8 * n + 2 * t4) =
          make_float2(o[4 * n + 2] * f1, o[4 * n + 3] * f1);
  }
}

// Encodes the three fp32 maps and launches the kernel on stream (grid:
// 128-row query blocks x H x B); kn and lsum are read / written in the
// partial mode only. Returns a cudaError_t; cudaErrorInvalidValue if a map
// cannot be encoded (a stride or base the TMA does not take).
template <int kMode, int G = kF32AttnGroupK8>
int launch_attention_f32_tma(const float* q, const float* k, const float* v, float* out,
                             const float* kn, float* lsum, int B, int Tq, int Tk, int H,
                             BthdStrides qs, BthdStrides ks, BthdStrides vs, float scale,
                             cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bthd_map(&q_map, q, B, Tq, H, 64, qs, kF32AttnRows, 4) ||
      !encode_bthd_map(&k_map, k, B, Tk, H, 64, ks, kF32AttnN, 4) ||
      !encode_bthd_map(&v_map, v, B, Tk, H, 64, vs, kF32AttnN, 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_f32_tma_kernel<kMode, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kF32AttnSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kF32AttnRows - 1) / kF32AttnRows, H, B);
  attention_f32_tma_kernel<kMode, G><<<grid, kF32AttnThreads, kF32AttnSmemBytes, stream>>>(
      q_map, k_map, v_map, out, kn, lsum, Tq, Tk, H, scale);
  return (int)cudaGetLastError();
}


// --- Head dims above 64: the sliced variant (every multiple of 64, D a
// run-time argument)
//
// The D 64 layout does not widen: Q 32 KB + two 80 KB stages is 192 KB at D
// 64, and at D 128 Q's 64 KB and two 160 KB stages pass the 227 KB a block
// has. So O goes in column slices, as bthd_attention.cuh's wide variant:
// * A block owns 128 query rows (the two consumer warpgroups of the D 64
//   loop) and a slice of DV = 128 columns of O; the grid's y is heads x
//   slices. Each block recomputes S = Q K^T over all of D, so the work is
//   (slices + 1) / 2 times the function's 4 Tq Tk D; columns of a last
//   slice past D load as zeros and are not stored.
// * Key tiles of NK = 96: S is one wgmma m64n96k8 per product and k8 step,
//   half again the work of the D 64 loop's m64n64k8 for the same issue
//   cost (64-key tiles measured 26-35% slower, 128-key ones 8-27%: their
//   S, its group and O pass the registers and ptxas spills and serialises
//   the wgmma, PERF.md). S streams K through a ring of units, one per
//   32-column box of D (one group of kF32AttnGroupK8 = 4 k8 steps, added in
//   fp32 as at D 64): a unit is K's box as landed (its big part), its small
//   parts, written by the split warps, and Q's box (128 rows x 32 columns),
//   read again from L2 every key tile (a resident Q takes 16 KB a box).
// * Q's A fragments: each consumer thread reads its floats of the box from
//   shared memory two k8 steps at a time and splits them in registers (raw
//   pattern big, tf32_small small), each pair one commit group into the
//   group's accumulator (the tensor cores add the group's 4 steps there
//   either way): Q held in registers would cost D registers, a whole
//   group's fragments 16 more than S, its group and O leave.
// * V's slice streams in stages of 32 keys (one group of 4 k8 steps of
//   O_tile = P V): V as landed, and V^T's big and small parts written by the
//   split warps in P's A-register key order (vt_column), so P goes from the
//   S accumulators to wgmma_tf32_rs with no shuffle, as at D 64; P's small
//   parts are rounded a stage at a time. O_tile's group is one wgmma
//   m64n128k8 per product.
// * The loop's other parts are the D 64 loop's: 4D fp32 tensor maps with row
//   extents Tq / Tk (rows past them zero-filled, keys >= Tk masked), 128-byte
//   swizzle, one producer thread, the warpgroups unsynchronised, the exact
//   running-max base-2 softmax on the pre-scaled logits, no split-K and no
//   atomics.
//
// Shared memory, the same at every D: 2 KB of mbarriers and alignment slack,
// three V stages of 48 KB (landed, V^T big and small: a key tile of V in
// flight; two stages, with Q's boxes resident in the room left, measured
// within 4%), two units of 40 KB: 231,424 bytes.
//
// Registers (setmaxnreg 232 a consumer thread): O 64, S and its group 48
// each, Q's fragments of two k8 steps 16; then O, O_tile's group 64, P 48
// and a stage's small parts 16. ptxas: no spills.

constexpr int kF32WideDV = 128;                       // columns of O a block owns
constexpr int kF32WideNK = 96;                        // keys a tile
constexpr int kF32WideQBox = kF32AttnRows * 32 * 4;  // bytes of a Q box: 128 rows x 32 columns
constexpr int kF32WideKBox = kF32WideNK * 128;       // bytes of a K box: 96 keys x 32 columns
constexpr int kF32WideUnit = 2 * kF32WideKBox + kF32WideQBox;  // K, K small, Q
constexpr int kF32WideUnits = 2;
constexpr int kF32WideVKeys = 32;                     // keys a V stage holds
constexpr int kF32WideVStage = 3 * 128 * kF32WideDV;  // bytes of a V stage: landed, V^T, V^T small
constexpr int kF32WideVStages = 3;
constexpr int kF32WideSmemBytes =
    2048 + kF32WideVStages * kF32WideVStage + kF32WideUnits * kF32WideUnit;
static_assert(kF32WideSmemBytes <= kSmemPerBlock,
              "the sliced fp32 attention's tiles exceed 227 KB of shared memory");

struct F32WideBars {
  uint64_t k_full[kF32WideUnits], k_ready[kF32WideUnits], k_empty[kF32WideUnits];
  uint64_t v_full[kF32WideVStages], v_ready[kF32WideVStages], v_empty[kF32WideVStages];
};
static_assert(sizeof(F32WideBars) <= 1024, "the sliced variant's mbarriers take 1 KB");

// A ring position: slot i of n, and the parity of its current round. The
// position is opaque to the compiler: with the ring sizes constant it
// otherwise proves each slot (a tile's three V stages in a ring of three)
// and keeps every slot's addresses in registers, which the wgmma pipeline
// then lacks (ptxas C7511: the products serialised, 11-16% slower on the
// card, PERF.md).
struct RingPos {
  int i = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int n) {
    if (++i == n) {
      i = 0;
      phase ^= 1;
    }
    asm volatile("" : "+r"(i), "+r"(phase));
  }
};

// d = one group of 4 k8 steps: A (registers: big ab, small as, the tf32 A
// layout per step) . B^T (a K-major box of N rows and 32 columns, big bb and
// small bs descriptors), scale-d 0 on the first step, as one commit group.
template <int N>
__device__ __forceinline__ void f32_group_products(float (&d)[N / 2], const uint32_t (&ab)[4][4],
                                                   const uint32_t (&as)[4][4], uint64_t bb,
                                                   uint64_t bs) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32_rs<N>(d, as[kk], bb + 2 * kk, kk == 0 ? 0 : 1);  // a k8 step: 32 bytes
    wgmma_tf32_rs<N>(d, ab[kk], bs + 2 * kk, 1);
    wgmma_tf32_rs<N>(d, ab[kk], bb + 2 * kk, 1);
  }
  wgmma_commit();
}

// Warps 1-3 of the producer warpgroup (sid 0..95), in the producer's order:
// each unit's K small parts, each V stage's V^T (both parts).
__device__ __forceinline__ void f32_wide_split(F32WideBars& bars, uint8_t* v_st, uint8_t* ring,
                                               int nb, int n_tiles, int sid) {
  constexpr int DV = kF32WideDV;
  const int warp = sid >> 5;
  const int lane = sid & 31;
  const int key = lane;  // V^T: a lane per key of the stage
  const int col = vt_column(key);
  RingPos u, sv;
  for (int j = 0; j < n_tiles; ++j) {
    for (int c = 0; c < nb; ++c) {
      mbar_wait(&bars.k_full[u.i], u.phase);
      uint8_t* unit = ring + u.i * kF32WideUnit;
      const float4* k = reinterpret_cast<const float4*>(unit);
      float4* ks = reinterpret_cast<float4*>(unit + kF32WideKBox);
      for (int i = sid; i < kF32WideKBox / 16; i += kF32AttnSplitThreads) {
        const float4 y = k[i];
        ks[i] = make_float4(tf32_small(y.x), tf32_small(y.y), tf32_small(y.z), tf32_small(y.w));
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars.k_ready[u.i]);
      u.next(kF32WideUnits);
    }
    for (int st = 0; st < kF32WideNK / kF32WideVKeys; ++st) {
      mbar_wait(&bars.v_full[sv.i], sv.phase);
      uint8_t* stage = v_st + sv.i * kF32WideVStage;
      const float* v = reinterpret_cast<const float*>(stage);  // DV/32 boxes of 32 keys x 32
      float* vt = reinterpret_cast<float*>(stage + 128 * DV);  // DV D-rows x 32 keys
      float* vts = reinterpret_cast<float*>(stage + 256 * DV);
      // chunk dc: columns 4 dc .. 4 dc + 3 of V; a 16-byte chunk c of row r
      // sits at chunk c ^ (r % 8) in both layouts
      for (int dc = warp; dc < DV / 4; dc += kF32AttnSplitThreads / 32) {
        const float4 x = *reinterpret_cast<const float4*>(
            v + (dc >> 3) * (kF32WideVKeys * 32) + key * 32 + (((dc & 7) ^ (key & 7)) << 2));
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * dc + e;
          const int off = d * 32 + ((((col >> 2) ^ (d & 7)) << 2) | (col & 3));
          vt[off] = xs[e];
          vts[off] = tf32_small(xs[e]);
        }
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars.v_ready[sv.i]);
      sv.next(kF32WideVStages);
    }
  }
}

// S's group: the unit's Q box . its K box into d, two commit groups of two
// k8 steps each waited for; then the unit is freed. q_row: this thread's
// byte offset in a Q box (the consumer's setup).
__device__ __forceinline__ void f32_wide_s_group(float (&d)[kF32WideNK / 2], F32WideBars& bars,
                                                 RingPos& u, const uint8_t* ring, int q_row,
                                                 int g, int lane) {
  mbar_wait(&bars.k_full[u.i], u.phase);
  mbar_wait(&bars.k_ready[u.i], u.phase);
  const uint8_t* unit = ring + u.i * kF32WideUnit;
  const uint8_t* rows = unit + 2 * kF32WideKBox + q_row;
  const uint64_t kb = smem_desc(unit), ks = smem_desc(unit + kF32WideKBox);
  constexpr int QK = 2;  // k8 steps of Q's fragments a commit group
#pragma unroll
  for (int k0 = 0; k0 < 4; k0 += QK) {
    uint32_t qb[QK][4], qs[QK][4];
#pragma unroll
    for (int k = 0; k < QK; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = *reinterpret_cast<const float*>(rows + (e & 1) * 8 * 128 +
                                                        (((2 * (k0 + k) + (e >> 1)) ^ g) << 4));
        qb[k][e] = __float_as_uint(x);
        qs[k][e] = __float_as_uint(tf32_small(x));
      }
    }
    fence_regs(d);
    fence_regs(qb);
    fence_regs(qs);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < QK; ++k) {
      const int kk = k0 + k;  // a k8 step: 32 bytes
      wgmma_tf32_rs<kF32WideNK>(d, qs[k], kb + 2 * kk, kk == 0 ? 0 : 1);
      wgmma_tf32_rs<kF32WideNK>(d, qb[k], ks + 2 * kk, 1);
      wgmma_tf32_rs<kF32WideNK>(d, qb[k], kb + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
  }
  if (lane == 0) mbar_arrive(&bars.k_empty[u.i]);  // the unit's K and Q boxes consumed
  u.next(kF32WideUnits);
}

// out (B, Tq, H, D) fp32 contiguous = softmax_2(scale q.k^T) v, normalised;
// one block: 128 query rows of one (batch, head) and O's columns c0 .. c0 +
// DV - 1 (blockIdx.y = h * slices + slice). The design above.
__global__ void __launch_bounds__(kF32AttnThreads, 1)
attention_f32_wide_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map, float* __restrict__ out,
                              int Tq, int Tk, int H, int D, int slices, float scale) {
  constexpr int DV = kF32WideDV;
  constexpr int NK = kF32WideNK;
  constexpr int kKBox = kF32WideKBox;
  constexpr int kVStages = NK / kF32WideVKeys;  // V stages a key tile
  extern __shared__ __align__(128) uint8_t smem_raw[];  // aligned to 1024 below
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  F32WideBars& bars = *reinterpret_cast<F32WideBars*>(base);
  uint8_t* v_st = base + 1024;                           // V's stages
  uint8_t* ring = v_st + kF32WideVStages * kF32WideVStage;  // units: K, K small, Q

  const int nb = D / 32;
  const int h = blockIdx.y / slices;
  const int c0 = (blockIdx.y - h * slices) * DV;
  const int q0 = blockIdx.x * kF32AttnRows;
  const int b = blockIdx.z;
  const int n_tiles = (Tk + NK - 1) / NK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int u = 0; u < kF32WideUnits; ++u) {
      mbar_init(&bars.k_full[u], 1);
      mbar_init(&bars.k_ready[u], kF32AttnSplitThreads / 32);  // one arrival per split warp
      mbar_init(&bars.k_empty[u], 8);                           // one arrival per consumer warp
    }
    for (int s = 0; s < kF32WideVStages; ++s) {
      mbar_init(&bars.v_full[s], 1);
      mbar_init(&bars.v_ready[s], kF32AttnSplitThreads / 32);
      mbar_init(&bars.v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer warpgroup: warp 0 loads, warps 1-3 split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      RingPos u, sv;
      for (int j = 0; j < n_tiles; ++j) {
        for (int c = 0; c < nb; ++c) {
          mbar_wait(&bars.k_empty[u.i], u.phase ^ 1);  // the first round passes
          uint8_t* unit = ring + u.i * kF32WideUnit;
          mbar_expect_tx(&bars.k_full[u.i], kKBox + kF32WideQBox);
          tma_load(unit, &k_map, &bars.k_full[u.i], 32 * c, h, j * NK, b);
          tma_load(unit + 2 * kKBox, &q_map, &bars.k_full[u.i], 32 * c, h, q0, b);
          u.next(kF32WideUnits);
        }
        for (int st = 0; st < kVStages; ++st) {
          mbar_wait(&bars.v_empty[sv.i], sv.phase ^ 1);
          uint8_t* stage = v_st + sv.i * kF32WideVStage;
          mbar_expect_tx(&bars.v_full[sv.i], 128 * DV);
          for (int x = 0; x < DV / 32; ++x)
            tma_load(stage + x * kF32WideVKeys * 128, &v_map, &bars.v_full[sv.i], c0 + 32 * x, h,
                     j * NK + kF32WideVKeys * st, b);
          sv.next(kF32WideVStages);
        }
      }
    } else if (threadIdx.x >= 32) {
      f32_wide_split(bars, v_st, ring, nb, n_tiles, threadIdx.x - 32);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;  // consumer warpgroup: query rows q0 + 64 cw .. q0 + 64 cw + 63
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // this thread's A fragments in a Q box: rows r and r + 8 (r % 8 = g),
  // columns 8kk + t4 and 8kk + t4 + 4 of k8 step kk, i.e. 16-byte chunks 2kk
  // and 2kk + 1 of its swizzled rows (chunk j of row r at j ^ (r % 8))
  const int q_row = (64 * cw + 16 * warp + g) * 128 + t4 * 4;

  float o[DV / 2], s[NK / 2], sp[NK / 2], op[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  Rows r;
  RingPos u, sv;

  for (int j = 0; j < n_tiles; ++j) {
    // S = Q K^T over D's boxes, each group added in fp32
    f32_wide_s_group(s, bars, u, ring, q_row, g, lane);
    for (int c = 1; c < nb; ++c) {
      f32_wide_s_group(sp, bars, u, ring, q_row, g, lane);
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) s[i] += sp[i];
    }

    // the online softmax on the scaled logits: s becomes P; O and l rescaled
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) s[i] *= scale;
    softmax_tile<NK>(r, s, j * NK, Tk, t4, 1.f);
    r.l0 = r.l0 * r.a0 + r.rs0;
    r.l1 = r.l1 * r.a1 + r.rs1;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[4 * n] *= r.a0;
      o[4 * n + 1] *= r.a0;
      o[4 * n + 2] *= r.a1;
      o[4 * n + 3] *= r.a1;
    }

    // O += P V by stages of 32 keys (k8 steps 4 st .. 4 st + 3), each group
    // added in fp32. P in the A order of k8 step i (k t <-> key 8i + 2t, k t
    // + 4 <-> key 8i + 2t + 1): big the raw pattern, small rounded.
#pragma unroll
    for (int st = 0; st < kVStages; ++st) {
      uint32_t pb[4][4], ps[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int i = 4 * st + kk;
        const float p4[4] = {s[4 * i], s[4 * i + 2], s[4 * i + 1], s[4 * i + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pb[kk][e] = __float_as_uint(p4[e]);
          ps[kk][e] = __float_as_uint(tf32_small(p4[e]));
        }
      }
      mbar_wait(&bars.v_full[sv.i], sv.phase);
      mbar_wait(&bars.v_ready[sv.i], sv.phase);
      const uint8_t* stage = v_st + sv.i * kF32WideVStage;
      fence_regs(op);
      fence_regs(pb);
      fence_regs(ps);
      wgmma_fence();
      f32_group_products<DV>(op, pb, ps, smem_desc(stage + 128 * DV), smem_desc(stage + 256 * DV));
      wgmma_wait<0>();
      fence_regs(op);
      fence_regs(pb);
      fence_regs(ps);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] += op[i];
      if (lane == 0) mbar_arrive(&bars.v_empty[sv.i]);  // the stage's V and V^T consumed
      sv.next(kF32WideVStages);
    }
  }

  float l0 = r.l0, l1 = r.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float f0 = 1.f / l0;
  const float f1 = 1.f / l1;
  const int row_a = q0 + 64 * cw + 16 * warp + g;
  const int row_b = row_a + 8;
  float* oa = out + (((size_t)b * Tq + row_a) * H + h) * D + c0 + 2 * t4;
  float* ob = oa + (size_t)8 * H * D;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    if (c0 + 8 * n >= D) continue;  // a last slice's columns past D
    if (row_a < Tq)
      *reinterpret_cast<float2*>(oa + 8 * n) = make_float2(o[4 * n] * f0, o[4 * n + 1] * f0);
    if (row_b < Tq)
      *reinterpret_cast<float2*>(ob + 8 * n) = make_float2(o[4 * n + 2] * f1, o[4 * n + 3] * f1);
  }
}

// Encodes the three fp32 maps (Q boxes of 128 rows, K of 96, V of 32) and
// launches the sliced variant (grid: 128-row query blocks x H x ceil(D /
// 128) slices x B). Returns a cudaError_t; cudaErrorInvalidValue if a map
// cannot be encoded.
inline int launch_attention_f32_wide(const float* q, const float* k, const float* v, float* out,
                                     int B, int Tq, int Tk, int H, int D, BthdStrides qs,
                                     BthdStrides ks, BthdStrides vs, float scale,
                                     cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bthd_map(&q_map, q, B, Tq, H, D, qs, kF32AttnRows, 4) ||
      !encode_bthd_map(&k_map, k, B, Tk, H, D, ks, kF32WideNK, 4) ||
      !encode_bthd_map(&v_map, v, B, Tk, H, D, vs, kF32WideVKeys, 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_f32_wide_tma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kF32WideSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int slices = (D + kF32WideDV - 1) / kF32WideDV;
  dim3 grid((Tq + kF32AttnRows - 1) / kF32AttnRows, H * slices, B);
  attention_f32_wide_tma_kernel<<<grid, kF32AttnThreads, kF32WideSmemBytes, stream>>>(
      q_map, k_map, v_map, out, Tq, Tk, H, D, slices, scale);
  return (int)cudaGetLastError();
}

}  // namespace pi3
