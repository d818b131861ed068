// Attention in float32 for Hopper (sm_90a): the fp32 entries of every
// attention row of PERF.md's kernel table, over (B, T, H, D) q / k / v read
// through their strides.
//
// Replaces, for float32 inputs, the Pallas TPU kernels of
// pi3_slam_tpu/ops/pallas_attention.py, which take any input dtype (on the
// TPU an fp32 model runs them in fp32: p is cast to v's dtype):
//   flash_attention_packed_tpu, attention_single_pass_packed_tpu (rows 1-2):
//     the packed (B, T, 3*H*64) projection as q / k / v views (row stride 3C,
//     head stride 64, row extent t_valid), any q_scale;
//   flash_attention_partial_tpu (row 5): the same loop with the partial
//     epilogue (unnormalised numerator and denominator, fixed shift);
//   flash_attention_tpu, attention_single_pass_tpu (rows 6-7): (B, T, H, D)
//     at every head dim that is a multiple of 64, keys masked by length.
// Per (batch, head), in fp32 throughout (P is kept in fp32, as the JAX fp32
// path keeps it):
//   s = scale * q.k^T (base 2), keys >= Tk masked, out = softmax_2(s) . v
// normalised (pi3_attention_f32), or acc = sum_j 2^(s_j - mh) v_j and l =
// sum_j 2^(s_j - mh) with mh = min(|q| scale kn + 1, 120)
// (pi3_partial_attention_f32; see partial_attention.cu for the contract).
// The scale multiplies the logits before the running max, so any scale
// (0 and negative ones too) is taken as it is.
//
// Head dim 64 (every fp32 launch of the main paths, the partial one too)
// runs the TMA + wgmma tf32 loop of bthd_attention_f32.cuh. The wider head
// dims run the mma.sync kernels below:
//
// Design: the products on the tensor cores in TF32 with the 3xTF32 split
// (mma.cuh), which keeps fp32's accuracy; TF32 alone would keep ~3 digits.
// A block of 4 warps owns 64 query rows of one head (16 a warp) and walks the
// keys in tiles of N (64 at D 128, 32 above) through two shared-memory
// stages filled by cp.async (16-byte chunks; rows past the extent are
// zero-filled and never read, so NaN behind the last row never loads). Q
// stays in shared memory. Per tile: S = Q K^T (D/8 k-steps of m16n8k8, each
// three products), the online softmax in registers (exact running max,
// exp2f), and O += P V with P straight from the S accumulators: a
// thread holds keys 2t and 2t+1 of an 8-key group, which m16n8k8's A operand
// wants at k t and t+4, so the k order of the P V product is permuted (k t
// <-> key 2t, k t+4 <-> key 2t+1) and V's rows are read in the same order.
// Shared-memory rows are D + 4 floats, so every fragment load is
// bank-conflict free.
//
// Above D 256 (O alone would pass the registers) the sliced variant runs
// (attention_f32_wide_kernel<DV>, D a run-time argument): the grid gains a
// column-slice dimension and each block owns a DV-wide slice of O (DV 128
// where 128 divides D, else 64), so O keeps at most D 128's registers. The
// block walks the keys in tiles of 32 and recomputes S = Q K^T for its
// slice with Q and K staged through shared memory in 64-column chunks (a
// two-stage cp.async ring over the (key tile, chunk) steps; Q's chunks are
// re-read from L2 every key tile), so shared memory does not grow with D;
// V's stages hold only the block's DV columns. The products, the
// zero-filled rows, the permuted P V order and the padded rows (a chunk's or
// slice's width + 4 floats) are the one-pass kernel's. The work is D / DV
// times the q.k^T of one pass.
//
// Bound on the H100: operations, 4 Tq Tk D per (batch, head) over 3xTF32's
// 165 TFLOP/s (a third of TF32's 495); at MoGe-2's encoder shape (1, 3537, 6
// x 64) 1.9e10, 0.12 ms. The mma.sync kernels were written to be right:
// synchronous stages, not the TMA + wgmma loop of head dim 64.

#include <math.h>

#include "bthd_attention_f32.cuh"

using namespace pi3;

namespace {

constexpr int kRows = 64;     // query rows a block
constexpr int kThreads = 128;  // 4 warps x 16 rows

template <int D>
struct F32Tiles {
  static constexpr int N = D <= 128 ? 64 : 32;  // keys a tile
  static constexpr int kLd = D + 4;             // floats a shared-memory row
  static constexpr int kSmem = (kRows + 4 * N) * kLd * 4;  // Q + two stages of K and V
  static_assert(kSmem <= 232448, "the fp32 attention tiles exceed 227 KB of shared memory");
};

// The sliced variant's tiles: two stages of a 64-column chunk of Q (kRows
// rows) and of K (N rows), and two stages of V's DV columns (N rows).
template <int DV>
struct F32WideTiles {
  static constexpr int N = 32;                  // keys a tile
  static constexpr int kLdC = 64 + 4;           // floats a row of a Q / K chunk
  static constexpr int kLdV = DV + 4;           // floats a row of V's slice
  static constexpr int kStage = (kRows + N) * kLdC;
  static constexpr int kSmem = (2 * kStage + 2 * N * kLdV) * 4;
  static_assert(kSmem <= 232448 / 2, "two sliced fp32 attention blocks exceed an SM's shared memory");
};

struct Strides {
  long long b, t, h;  // element strides of (B, T, H, D); unit stride over D
};

// rows [row0, row0 + R) x D of one (b, h) -> dst (R rows of kLd floats);
// rows >= extent are zero-filled and not read.
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ base, Strides st,
                                          int b, int h, int row0, int extent) {
  constexpr int kChunks = D / 4;
  const float* src = base + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const bool valid = row0 + r < extent;
    cp_async16(dst + r * F32Tiles<D>::kLd + c, src + (valid ? row0 + r : 0) * st.t + c, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Strides qs, Strides ks, Strides vs,
                     float* __restrict__ out, int Tq, int Tk, int H, float scale) {
  using Tiles = F32Tiles<D>;
  constexpr int N = Tiles::N;
  constexpr int kLd = Tiles::kLd;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                    // kRows x kLd
  float* skv = smem + kRows * kLd;     // stage s: K at 2sN rows, V at (2s + 1)N rows

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = (Tk + N - 1) / N;

  load_rows<D, kRows>(sq, q, qs, b, h, q0, Tq);
  load_rows<D, N>(skv, k, ks, b, h, 0, Tk);
  load_rows<D, N>(skv + N * kLd, v, vs, b, h, 0, Tk);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the scaled logits, rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums
  const float* qw = sq + (16 * warp + g) * kLd;  // the warp's rows g and g + 8 (+ 8 kLd)

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      float* next = skv + ((j + 1) & 1) * 2 * N * kLd;
      load_rows<D, N>(next, k, ks, b, h, (j + 1) * N, Tk);
      load_rows<D, N>(next + N * kLd, v, vs, b, h, (j + 1) * N, Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q) landed; tile j + 1 may be in flight
    __syncthreads();
    const float* sk = skv + (j & 1) * 2 * N * kLd;
    const float* sv = sk + N * kLd;

    // S = Q K^T: s[n] holds keys 8n .. 8n + 7 of the tile
    float s[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = 8 * kk + t;
      const Tf32Pair a[4] = {split_tf32(qw[c]), split_tf32(qw[8 * kLd + c]),
                             split_tf32(qw[c + 4]), split_tf32(qw[8 * kLd + c + 4])};
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        const float* kr = sk + (8 * n + g) * kLd + c;
        const Tf32Pair bk[2] = {split_tf32(kr[0]), split_tf32(kr[4])};
        mma_3xtf32(s[n], a, bk);
      }
    }

    // online softmax (base 2) on the scaled logits; keys >= Tk masked
    const int k0 = j * N;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool masked = k0 + 8 * n + 2 * t + e >= Tk;
        s[n][e] = masked ? -INFINITY : s[n][e] * scale;
        s[n][2 + e] = masked ? -INFINITY : s[n][2 + e] * scale;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0);  // 0 on the first tile (m = -inf); key 0 < Tk keeps mx finite
    const float a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mx0);
      s[n][1] = exp2f(s[n][1] - mx0);
      s[n][2] = exp2f(s[n][2] - mx1);
      s[n][3] = exp2f(s[n][3] - mx1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P V, key group n as one k-step in the permuted order (k t <-> key
    // 2t, k t + 4 <-> key 2t + 1)
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const Tf32Pair p[4] = {split_tf32(s[n][0]), split_tf32(s[n][2]), split_tf32(s[n][1]),
                             split_tf32(s[n][3])};
      const float* vr = sv + (8 * n + 2 * t) * kLd + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const Tf32Pair bv[2] = {split_tf32(vr[8 * dn]), split_tf32(vr[kLd + 8 * dn])};
        mma_3xtf32(o[dn], p, bv);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row_a = q0 + 16 * warp + g;
  const int row_b = row_a + 8;
  const size_t ra = ((size_t)b * Tq + row_a) * H + h;  // (b, row, h) of (B, Tq, H)
  const size_t rb = ra + (size_t)8 * H;
  const float f0 = 1.f / l0;
  const float f1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row_a < Tq)
      *reinterpret_cast<float2*>(out + ra * D + 8 * n + 2 * t) =
          make_float2(o[n][0] * f0, o[n][1] * f0);
    if (row_b < Tq)
      *reinterpret_cast<float2*>(out + rb * D + 8 * n + 2 * t) =
          make_float2(o[n][2] * f1, o[n][3] * f1);
  }
}

// --- the sliced variant (D > 256)

// rows [row0, row0 + R) x W columns from src (row stride st_t) -> dst (R
// rows of LD floats); rows >= extent are zero-filled and not read.
template <int W, int R, int LD>
__device__ __forceinline__ void load_cols(float* dst, const float* __restrict__ src, long long st_t,
                                          int row0, int extent) {
  constexpr int kChunks = W / 4;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const bool valid = row0 + r < extent;
    cp_async16(dst + r * LD + c, src + (valid ? row0 + r : 0) * st_t + c, valid);
  }
}

// s[n] (keys 8n .. 8n + 7 of the tile) += the warp's 16 query rows (qw: row
// g, row stride LD) . the tile's keys (sk, row stride LD) over W columns.
template <int N, int W, int LD>
__device__ __forceinline__ void tile_logits(float (&s)[N / 8][4], const float* qw, const float* sk,
                                            int g, int t) {
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    const int c = 8 * kk + t;
    const Tf32Pair a[4] = {split_tf32(qw[c]), split_tf32(qw[8 * LD + c]),
                           split_tf32(qw[c + 4]), split_tf32(qw[8 * LD + c + 4])};
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float* kr = sk + (8 * n + g) * LD + c;
      const Tf32Pair bk[2] = {split_tf32(kr[0]), split_tf32(kr[4])};
      mma_3xtf32(s[n], a, bk);
    }
  }
}

// The running softmax state of this thread's rows g and g + 8.
struct F32Rows {
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the scaled logits
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums
};

// Online softmax (base 2) of one tile's logits (keys k0 ..; keys >= Tk
// masked): s becomes P, O (DO columns) and the row sums are rescaled.
template <int N, int DO>
__device__ __forceinline__ void softmax_tile(F32Rows& r, float (&s)[N / 8][4],
                                             float (&o)[DO / 8][4], int k0, int Tk, int t,
                                             float scale) {
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool masked = k0 + 8 * n + 2 * t + e >= Tk;
      s[n][e] = masked ? -INFINITY : s[n][e] * scale;
      s[n][2 + e] = masked ? -INFINITY : s[n][2 + e] * scale;
    }
    mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
    mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float a0 = exp2f(r.m0 - mx0);  // 0 on the first tile (m = -inf); key 0 < Tk keeps mx finite
  const float a1 = exp2f(r.m1 - mx1);
  r.m0 = mx0;
  r.m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    s[n][0] = exp2f(s[n][0] - mx0);
    s[n][1] = exp2f(s[n][1] - mx0);
    s[n][2] = exp2f(s[n][2] - mx1);
    s[n][3] = exp2f(s[n][3] - mx1);
    rs0 += s[n][0] + s[n][1];
    rs1 += s[n][2] + s[n][3];
  }
  r.l0 = r.l0 * a0 + rs0;
  r.l1 = r.l1 * a1 + rs1;
#pragma unroll
  for (int n = 0; n < DO / 8; ++n) {
    o[n][0] *= a0;
    o[n][1] *= a0;
    o[n][2] *= a1;
    o[n][3] *= a1;
  }
}

// O += P V over the tile's N keys (sv: V's rows, row stride LD, DO
// columns), key group n as one k-step in the permuted order (k t <-> key
// 2t, k t + 4 <-> key 2t + 1)
template <int N, int DO, int LD>
__device__ __forceinline__ void tile_pv(float (&o)[DO / 8][4], const float (&s)[N / 8][4],
                                        const float* sv, int g, int t) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const Tf32Pair p[4] = {split_tf32(s[n][0]), split_tf32(s[n][2]), split_tf32(s[n][1]),
                           split_tf32(s[n][3])};
    const float* vr = sv + (8 * n + 2 * t) * LD + g;
#pragma unroll
    for (int dn = 0; dn < DO / 8; ++dn) {
      const Tf32Pair bv[2] = {split_tf32(vr[8 * dn]), split_tf32(vr[LD + 8 * dn])};
      mma_3xtf32(o[dn], p, bv);
    }
  }
}

// The row sums of rows g and g + 8 over the quad.
__device__ __forceinline__ void reduce_row_sums(F32Rows& r) {
  r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, 1);
  r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, 2);
  r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, 1);
  r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, 2);
}

// O's DO columns of rows a and b (oa / ob: their first column), scaled by
// f0 / f1; rows past Tq are not stored.
template <int DO>
__device__ __forceinline__ void store_rows(float* oa, float* ob, const float (&o)[DO / 8][4],
                                           float f0, float f1, bool valid_a, bool valid_b, int t) {
#pragma unroll
  for (int n = 0; n < DO / 8; ++n) {
    if (valid_a)
      *reinterpret_cast<float2*>(oa + 8 * n + 2 * t) = make_float2(o[n][0] * f0, o[n][1] * f0);
    if (valid_b)
      *reinterpret_cast<float2*>(ob + 8 * n + 2 * t) = make_float2(o[n][2] * f1, o[n][3] * f1);
  }
}

// The sliced variant (the design in the header): blockIdx.y = h * (D / DV)
// + slice; the block's O holds columns [slice DV, slice DV + DV) of head h.
// Step i of the ring is key tile i / (D / 64), Q / K chunk i % (D / 64); V's
// slice of a tile comes with the tile's first chunk, in its own two stages.
template <int DV>
__global__ void __launch_bounds__(kThreads, 2)
attention_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, Strides qs, Strides ks, Strides vs,
                          float* __restrict__ out, int Tq, int Tk, int H, int D, float scale) {
  using Tiles = F32WideTiles<DV>;
  constexpr int N = Tiles::N;
  constexpr int kLdC = Tiles::kLdC;
  constexpr int kLdV = Tiles::kLdV;
  extern __shared__ __align__(16) float smem[];
  float* sv0 = smem + 2 * Tiles::kStage;  // V stage s at sv0 + s N kLdV

  const int n_slices = D / DV;
  const int h = blockIdx.y / n_slices;
  const int c0 = (blockIdx.y - h * n_slices) * DV;
  const int q0 = blockIdx.x * kRows;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h + c0;
  const int n_chunks = D / 64;
  const int n_steps = (Tk + N - 1) / N * n_chunks;

  auto issue = [&](int i) {  // step i's Q and K chunks (and V's slice on a tile's first chunk)
    const int j = i / n_chunks;
    const int c = i - j * n_chunks;
    float* stage = smem + (i & 1) * Tiles::kStage;
    load_cols<64, kRows, kLdC>(stage, qp + 64 * c, qs.t, q0, Tq);
    load_cols<64, N, kLdC>(stage + kRows * kLdC, kp + 64 * c, ks.t, j * N, Tk);
    if (c == 0) load_cols<DV, N, kLdV>(sv0 + (j & 1) * N * kLdV, vp, vs.t, j * N, Tk);
  };
  issue(0);
  cp_async_commit();

  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float s[N / 8][4];
  F32Rows rows;

  for (int i = 0; i < n_steps; ++i) {
    const int j = i / n_chunks;
    const int c = i - j * n_chunks;
    if (i + 1 < n_steps) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step i landed; step i + 1 may be in flight
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < N / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
    const float* stage = smem + (i & 1) * Tiles::kStage;
    tile_logits<N, 64, kLdC>(s, stage + (16 * warp + g) * kLdC, stage + kRows * kLdC, g, t);
    if (c == n_chunks - 1) {
      softmax_tile<N, DV>(rows, s, o, j * N, Tk, t, scale);
      tile_pv<N, DV, kLdV>(o, s, sv0 + (j & 1) * N * kLdV, g, t);
    }
    __syncthreads();  // this stage is refilled on the next step, V's two tiles on
  }

  reduce_row_sums(rows);
  const int row_a = q0 + 16 * warp + g;
  const int row_b = row_a + 8;
  const size_t ra = ((size_t)b * Tq + row_a) * H + h;
  const size_t rb = ra + (size_t)8 * H;
  store_rows<DV>(out + ra * D + c0, out + rb * D + c0, o, 1.f / rows.l0, 1.f / rows.l1,
                 row_a < Tq, row_b < Tq, t);
}

template <int D>
int launch(const float* q, const float* k, const float* v, Strides qs, Strides ks, Strides vs,
           float* out, int B, int Tq, int Tk, int H, float scale, cudaStream_t stream) {
  constexpr int smem = F32Tiles<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kRows - 1) / kRows, H, B);
  attention_f32_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, qs, ks, vs, out, Tq, Tk, H,
                                                            scale);
  return (int)cudaGetLastError();
}

template <int DV>
int launch_wide(const float* q, const float* k, const float* v, Strides qs, Strides ks,
                Strides vs, float* out, int B, int Tq, int Tk, int H, int D, float scale,
                cudaStream_t stream) {
  constexpr int smem = F32WideTiles<DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(attention_f32_wide_kernel<DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kRows - 1) / kRows, H * (D / DV), B);
  attention_f32_wide_kernel<DV><<<grid, kThreads, smem, stream>>>(q, k, v, qs, ks, vs, out, Tq,
                                                                  Tk, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Tq, H, D), k / v (B, Tk, H, D) fp32 with the given element strides
// (unit stride over D, the others multiples of 4, bases 16-byte aligned);
// out (B, Tq, H, D) fp32, contiguous: softmax_2(scale * q.k^T) . v with keys
// >= Tk masked. D must be a positive multiple of 64 (cudaErrorInvalidValue
// otherwise): 64 on the TMA + wgmma loop, 128-256 in one pass, wider ones in
// slices of 128 columns where 128 divides D, else of 64. Returns a
// cudaError_t.
extern "C" int pi3_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                 int Tq, int Tk, int H, int D, long long q_sb, long long q_st,
                                 long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh, float scale,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch_attention_f32_tma<kSoftmax>(qp, kp, vp, op, nullptr, nullptr, B, Tq, Tk, H,
                                                {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
                                                {v_sb, v_st, v_sh}, scale, s);
    case 128:
      return launch<128>(qp, kp, vp, qs, ks, vs, op, B, Tq, Tk, H, scale, s);
    case 192:
      return launch<192>(qp, kp, vp, qs, ks, vs, op, B, Tq, Tk, H, scale, s);
    case 256:
      return launch<256>(qp, kp, vp, qs, ks, vs, op, B, Tq, Tk, H, scale, s);
    default:
      if (D <= 0 || D % 64) return (int)cudaErrorInvalidValue;
      if (D % 128 == 0)
        return launch_wide<128>(qp, kp, vp, qs, ks, vs, op, B, Tq, Tk, H, D, scale, s);
      return launch_wide<64>(qp, kp, vp, qs, ks, vs, op, B, Tq, Tk, H, D, scale, s);
  }
}

// The partial epilogue at head dim 64: q, k, v as above; kn (B, H) fp32; acc
// (B, Tq, H, 64) and l (B, Tq, H) fp32, contiguous. scale = 64^-1/2 log2(e).
extern "C" int pi3_partial_attention_f32(const void* q, const void* k, const void* v,
                                         const void* kn, void* acc, void* l, int B, int Tq, int Tk,
                                         int H, long long q_sb, long long q_st, long long q_sh,
                                         long long k_sb, long long k_st, long long k_sh,
                                         long long v_sb, long long v_st, long long v_sh,
                                         float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_attention_f32_tma<kPartialSums>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(acc), static_cast<const float*>(kn), static_cast<float*>(l), B, Tq, Tk,
      H, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}, scale,
      (cudaStream_t)stream);
}
