// The fp32 attention loop at head dim 64 for Hopper (sm_90a): every fp32
// attention launch at D 64 of attention_f32.cu (pi3_attention_f32 at D 64:
// the packed projection's q / k / v views and (B, T, H, 64) tensors, and
// pi3_partial_attention_f32), as TMA + wgmma tf32 with the 3xTF32 split.
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

}  // namespace pi3
