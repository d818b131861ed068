// The TMA + wgmma attention loop over (B, T, H, D) q / k / v for Hopper
// (sm_90a), shared by attention.cu (softmax(q.k^T * D^-1/2) . v, normalised,
// bf16 out; head dims above 256 in the wide variant at the end of this file),
// partial_attention.cu (the bound-shift partial sums acc and l, fp32 out) and
// dots_attention.cu (the products alone, bf16(sum bf16(q.k^T) v): no max, no
// exp2, no row sum, unnormalised). It is packed_attention.cu's loop with one
// tensor map per operand in place of one map over the packed projection:
//
// * Loads. q, k and v each get a 4D tensor map (D columns, H heads, T rows,
//   B) over their own byte strides, so strided views (the q / k / v of a qkv
//   projection, keys cut from a longer buffer) need no copy. The row extent
//   is Tq for q and Tk for k and v: rows past it come in zero-filled (never
//   the rows behind it in memory, never the next batch row), and keys >= Tk
//   are masked to -inf before the max, since a zero key is a logit of 0, not
//   an absent key. 128-byte swizzle, 64-column boxes: a D-wide tile is D/64
//   boxes, each rows x 128 bytes, 1024-byte aligned. One producer thread
//   issues Q once per block and K, V per key tile into a ring of stages,
//   each with a full and an empty mbarrier (at D 192 and 256 one pair for
//   K and one for V, the tile table below).
// * Products. Two consumer warpgroups of 64 query rows each (a block 128).
//   S = Q K^T is wgmma m64nNk16 with both operands in shared memory (K rows
//   the K-major B operand), D/16 k-steps: 32 bytes apart in a box, a box
//   apart every fourth. O += P V is wgmma m64nDk16 with P from registers and
//   V the MN-major (transposed) B operand, N/16 k-steps of 2048 bytes; at D >
//   64 its N spans D/64 boxes, the descriptor's leading byte offset apart.
// * Softmax and overlap: hopper.cuh's base-2 online softmax, exact running
//   max; FlashAttention-3's two overlaps, as in packed_attention.cu: S_j is
//   issued with P_{j-1} V_{j-1} and its softmax runs under the latter, and
//   named barriers make the two warpgroups take turns at issuing products.
//
// Tiles by head dim, to fit 240 consumer registers (O D/2, S N/2 and P N/4
// live at once) and 227 KB of shared memory (Q 256 D bytes, each stage 4 N D):
//
//   D    key tile N  stages  K / V barriers  O + S + P regs  shared memory
//   64   128         3       shared          32 + 64 + 32    114,688 + barriers
//   128  128         3       shared          64 + 64 + 32    229,376
//   192  80          2       split           96 + 40 + 20    172,032
//   256  80          2       split           128 + 40 + 20   229,376
//
// Every 128-row block reads all of K and V from L2, 128 flops a byte at any
// D. With one barrier a stage (K and V of a tile) is freed only once both
// warpgroups have finished P V on it, so its refill has less than a turn to
// land; at D 192 and 256 a tile is 48-80 KB. Split: K and V of a stage on
// full / empty barriers of their own (FlashAttention-3's pipeline_k and
// pipeline_v); the producer issues K_{j+1} before V_j, K_j is refilled once
// S_j has been read and V_j once P_j V_j has, so K has two turns to land and
// V more than one. 80-key tiles (FlashAttention-3's at D 256) issue a fifth
// fewer wgmma for S than 64-key ones and fill the 227 KB with two stages.
//
// The tiles were chosen on an H100 by timing builds with other tiles: at D
// 128 three stages beat two, at D 64 a fourth gained nothing. At D 256, on
// one NVIDIA H100 80GB HBM3, 700.00 W at (1, 8192, 4, 256) (perf_lab tiles):
// 64-key tiles on shared barriers 0.624-0.655 ms, split 0.412-0.419, 80-key
// tiles shared 0.551-0.557, split 0.378-0.379 (SDPA 0.389-0.395); at D 192
// 64-key tiles on three shared stages 0.322-0.338 ms, split 0.332-0.355, 80
// split on two 0.302-0.305 (SDPA 0.299-0.305).
//
// Bound on the H100: the two products, 4 Tq Tk D flops per (batch, head), at
// 989 TFLOP/s; at D 64 the exp2 (one per logit, ~3.9e12/s) weighs as much.
#pragma once

#include "hopper.cuh"

namespace pi3 {

constexpr int kBthdBlockM = 128;  // query rows per block: two consumer warpgroups of 64
constexpr int kBthdThreads = 384;  // producer warpgroup + two consumer warpgroups

// Key tile, ring stages and barriers by head dim (the table above).
// kSplitKv: K and V of a stage on full / empty mbarriers of their own, so
// that K_j is refilled once S_j has read it and V_j once P_j V_j has.
template <int N, int S, bool kSplitKv = false>
struct TileShape {
  static constexpr int kBlockN = N, kStages = S;
  static constexpr bool kSplit = kSplitKv;
};
template <int D>
struct BthdTiles;
template <>
struct BthdTiles<64> : TileShape<128, 3> {};
template <>
struct BthdTiles<128> : TileShape<128, 3> {};
template <>
struct BthdTiles<192> : TileShape<80, 2, true> {};
template <>
struct BthdTiles<256> : TileShape<80, 2, true> {};

template <int D>
struct __align__(1024) BthdSmem {  // 128-byte swizzle wants 1024-byte aligned tiles
  static constexpr int N = BthdTiles<D>::kBlockN;
  static constexpr int S = BthdTiles<D>::kStages;
  __nv_bfloat16 q[kBthdBlockM * D];  // box c (columns 64c ..) at 128 * 64 * c
  __nv_bfloat16 k[S][N * D];         // box c at N * 64 * c
  __nv_bfloat16 v[S][N * D];
  uint64_t q_full;
  uint64_t full[S];   // K and V of the stage (K alone where split)
  uint64_t empty[S];
  uint64_t full_v[BthdTiles<D>::kSplit ? S : 1];  // V alone where split
  uint64_t empty_v[BthdTiles<D>::kSplit ? S : 1];
};

template <int D>
constexpr int bthd_smem_bytes() {
  return sizeof(BthdSmem<D>) + 1024;  // + slack to align the dynamic base
}

// Each instantiation fits the H100's 227 KB of shared memory a block.
static_assert(bthd_smem_bytes<64>() <= 232448 && bthd_smem_bytes<128>() <= 232448 &&
                  bthd_smem_bytes<192>() <= 232448 && bthd_smem_bytes<256>() <= 232448,
              "a tile table entry exceeds 227 KB of shared memory");

// S = Q K^T for the warpgroup's 64 query rows (q: its rows in box 0) and one
// N-key tile.
template <int D, int N>
__device__ __forceinline__ void bthd_issue_qk(float (&acc)[N / 2], const __nv_bfloat16* q,
                                              const __nv_bfloat16* k) {
  const uint64_t q_desc = smem_desc(q);
  const uint64_t k_desc = smem_desc(k);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // in 16-byte units: a box of Q is 128 rows of 128 bytes, one of K N rows
    const int in_box = 2 * (kk % 4);
    wgmma_ss<N>(acc, q_desc + (kk / 4) * (kBthdBlockM * 8) + in_box,
                k_desc + (kk / 4) * (N * 8) + in_box, kk);
  }
  wgmma_commit();
}

// O += P V: N/16 k-steps of 16 keys, 16 rows of V (2048 bytes) each.
template <int D, int N>
__device__ __forceinline__ void bthd_issue_pv(float (&o)[D / 2], const uint32_t (&p)[N / 16][4],
                                              uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) wgmma_rs<D>(o, p[kk], v_desc + kk * (2048 >> 4));
  wgmma_commit();
}

// What the loop computes and writes. The products-only mode keeps the ring,
// tiles, warpgroups, ping-pong and issue order of the others, so its time
// beside theirs is the softmax's cost on this loop.
enum BthdMode {
  // out (B, Tq, H, D) bf16 contiguous, normalised by the row sum
  kSoftmax = 0,
  // (D 64) out = acc (B, Tq, H, 64) and lsum = l (B, Tq, H), fp32 contiguous,
  // both scaled by 2^-mh with mh = min(|q| scale_log2 kn[b, h] + 1, 120) (see
  // partial_attention.cu)
  kPartialSums = 1,
  // out = bf16(sum_k bf16(S) V) (B, Tq, H, D) bf16 contiguous: P is S rounded
  // to nearest even, no max, exp2 or row sum; zero-filled keys past Tk give
  // logits of 0 against v rows of 0, so no mask is needed
  kProductsOnly = 2,
};
template <int D, int kMode>
__global__ void __launch_bounds__(kBthdThreads, 1)
bthd_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, void* __restrict__ out,
                      const float* __restrict__ kn, float* __restrict__ lsum, int Tq, int Tk,
                      int H, float scale_log2) {
  constexpr int N = BthdTiles<D>::kBlockN;
  constexpr int S = BthdTiles<D>::kStages;
  constexpr bool kSplit = BthdTiles<D>::kSplit;
  extern __shared__ __align__(128) uint8_t smem_raw[];  // aligned to 1024 below
  const uint32_t raw = smem_u32(smem_raw);
  BthdSmem<D>& sm = *reinterpret_cast<BthdSmem<D>*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));

  const int q0 = blockIdx.x * kBthdBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (Tk + N - 1) / N;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
      if constexpr (kSplit) {
        mbar_init(&sm.full_v[s], 1);
        mbar_init(&sm.empty_v[s], 8);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kBthdBlockM * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load(sm.q + c * kBthdBlockM * 64, &q_map, &sm.q_full, 64 * c, h, q0, b);
      if constexpr (kSplit) {
        // in the order the consumers take them: K_0, then K_{j+1} before V_j
        // (turn j issues S_j with P_{j-1} V_{j-1})
        auto load = [&](const CUtensorMap* map, __nv_bfloat16 (*dst)[N * D], uint64_t* full,
                        uint64_t* empty, int j) {
          const int s = j % S;
          mbar_wait(&empty[s], ((j / S) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(&full[s], N * D * 2);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load(dst[s] + c * N * 64, map, &full[s], 64 * c, h, j * N, b);
        };
        load(&k_map, sm.k, sm.full, sm.empty, 0);
        for (int j = 0; j < n_tiles; ++j) {
          if (j + 1 < n_tiles) load(&k_map, sm.k, sm.full, sm.empty, j + 1);
          load(&v_map, sm.v, sm.full_v, sm.empty_v, j);
        }
      } else {
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % S;
          mbar_wait(&sm.empty[s], ((j / S) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(&sm.full[s], 2 * N * D * 2);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load(sm.k[s] + c * N * 64, &k_map, &sm.full[s], 64 * c, h, j * N, b);
            tma_load(sm.v[s] + c * N * 64, &v_map, &sm.full[s], 64 * c, h, j * N, b);
          }
        }
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
  const __nv_bfloat16* q_rows = sm.q + c * 64 * 64;  // this warpgroup's rows of box 0
  const uint32_t v_box_bytes = N * 128;  // leading byte offset of V's boxes
  // Ping-pong: warpgroup c issues its products after bar.sync on barrier 1 + c
  // and then lets the other one issue (bar.arrive on 2 - c). Warpgroup 0 opens
  // its own barrier for its first turn.
  const uint32_t my_bar = 1 + c;
  const uint32_t other_bar = 2 - c;

  float o[D / 2];
  float acc[N / 2];
  uint32_t p[N / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
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
  bthd_issue_qk<D, N>(acc, q_rows, sm.k[0]);
  bar_arrive(other_bar);
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (kSplit)
    if (lane == 0) mbar_arrive(&sm.empty[0]);  // K_0 read
  if constexpr (kMode == kProductsOnly) {
    pack_p<N>(p, acc);
  } else {
    softmax_tile<N>(r, acc, 0, Tk, t4, scale_log2);
    finish_tile<N, D>(r, o, p, acc);
  }

  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % S;
    const int prev = (j - 1) % S;
    mbar_wait(&sm.full[s], (j / S) & 1);
    if constexpr (kSplit) mbar_wait(&sm.full_v[prev], ((j - 1) / S) & 1);
    bar_sync(my_bar);
    fence_regs(acc);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    bthd_issue_qk<D, N>(acc, q_rows, sm.k[s]);
    bthd_issue_pv<D, N>(o, p, smem_desc(sm.v[prev], v_box_bytes));
    bar_arrive(other_bar);
    wgmma_wait<1>();  // S_j done; P_{j-1} V_{j-1} may still run
    fence_regs(acc);
    if constexpr (kSplit)
      if (lane == 0) mbar_arrive(&sm.empty[s]);  // K_j read
    if constexpr (kMode != kProductsOnly) softmax_tile<N>(r, acc, j * N, Tk, t4, scale_log2);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (lane == 0)  // V (and K, where not split) of tile j-1 consumed
      mbar_arrive(kSplit ? &sm.empty_v[prev] : &sm.empty[prev]);
    if constexpr (kMode == kProductsOnly) pack_p<N>(p, acc);
    else finish_tile<N, D>(r, o, p, acc);
  }

  const int last = (n_tiles - 1) % S;
  if constexpr (kSplit) mbar_wait(&sm.full_v[last], ((n_tiles - 1) / S) & 1);
  bar_sync(my_bar);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
  bthd_issue_pv<D, N>(o, p, smem_desc(sm.v[last], v_box_bytes));
  if (c == 0) bar_arrive(other_bar);  // warpgroup 1's last turn has no successor
  wgmma_wait<0>();
  fence_regs(o);
  if (lane == 0) mbar_arrive(kSplit ? &sm.empty_v[last] : &sm.empty[last]);

  float l0 = r.l0, l1 = r.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row_a = q0 + 64 * c + 16 * warp + (lane >> 2);
  const int row_b = row_a + 8;
  const size_t ra = ((size_t)b * Tq + row_a) * H + h;  // (b, row, h) of (B, Tq, H)
  const size_t rb = ra + (size_t)8 * H;

  if constexpr (kMode == kPartialSums) {
    static_assert(D == 64, "the partial epilogue is written for head dim 64");
    // |q|^2 of rows r0 and r0 + 8 from Q in shared memory: each thread of the
    // quad sums two of a row's eight 16-byte chunks. The swizzle permutes the
    // chunks within their 128-byte row (chunk index XOR row % 8), so the
    // row's eight chunks hold its 64 columns whatever the order.
    float qq0 = 0.f, qq1 = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + (lane >> 2) + 8 * half;
      const uint4* chunks = reinterpret_cast<const uint4*>(q_rows + row * 64) + 2 * t4;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 w = chunks[i];
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // a bf16 is the upper half of the fp32 with the same value
          const float lo = __uint_as_float(words[j] << 16);
          const float hi = __uint_as_float(words[j] & 0xffff0000u);
          sq += lo * lo + hi * hi;
        }
      }
      (half ? qq1 : qq0) = sq;
    }
    qq0 += __shfl_xor_sync(0xffffffffu, qq0, 1);
    qq0 += __shfl_xor_sync(0xffffffffu, qq0, 2);
    qq1 += __shfl_xor_sync(0xffffffffu, qq1, 1);
    qq1 += __shfl_xor_sync(0xffffffffu, qq1, 2);
    const float knh = kn[b * H + h];
    const float mh0 = fminf(sqrtf(qq0) * scale_log2 * knh + 1.f, 120.f);
    const float mh1 = fminf(sqrtf(qq1) * scale_log2 * knh + 1.f, 120.f);
    // from the running max m to the fixed shift mh (m <= mh - 1 unless the
    // clamp at 120 binds, so the factor is at most 1/2 there)
    const float f0 = exp2f(r.m0 * scale_log2 - mh0);
    const float f1 = exp2f(r.m1 * scale_log2 - mh1);
    float* acc_out = static_cast<float*>(out);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (row_a < Tq)
        *reinterpret_cast<float2*>(acc_out + ra * D + 8 * n + 2 * t4) =
            make_float2(o[4 * n] * f0, o[4 * n + 1] * f0);
      if (row_b < Tq)
        *reinterpret_cast<float2*>(acc_out + rb * D + 8 * n + 2 * t4) =
            make_float2(o[4 * n + 2] * f1, o[4 * n + 3] * f1);
    }
    if (t4 == 0) {
      if (row_a < Tq) lsum[ra] = l0 * f0;
      if (row_b < Tq) lsum[rb] = l1 * f1;
    }
  } else {
    // normalised by the row sum, or (products only) as summed
    const float inv0 = kMode == kSoftmax ? 1.f / l0 : 1.f;
    const float inv1 = kMode == kSoftmax ? 1.f / l1 : 1.f;
    __nv_bfloat16* oa = static_cast<__nv_bfloat16*>(out) + ra * D + 2 * t4;
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out) + rb * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (row_a < Tq)
        *reinterpret_cast<uint32_t*>(oa + n * 8) = pack_float2(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (row_b < Tq)
        *reinterpret_cast<uint32_t*>(ob + n * 8) = pack_float2(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

// Element strides of a (B, T, H, D) tensor (unit stride over D).
struct BthdStrides {
  long long b, t, h;
};

// The tensor map of a (B, T, H, D) bf16 (elem_bytes 2) or fp32 (4) tensor:
// dims (D, H, T, B) over its byte strides (each a multiple of 16, base
// 16-byte aligned), 128-byte swizzle, boxes of one 128-byte row of columns
// (64 bf16, 32 fp32) x 1 head x rows x 1. Rows >= T (and any coordinate past
// its extent) load as zeros.
inline bool encode_bthd_map(CUtensorMap* map, const void* base, int B, int T, int H, int D,
                            BthdStrides st, int rows, int elem_bytes = 2) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(st.h * elem_bytes), (cuuint64_t)(st.t * elem_bytes),
                                 (cuuint64_t)(st.b * elem_bytes)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem_bytes), 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Encodes the three maps and launches the kernel on stream (grid: 128-row
// query blocks x H x B). Returns a cudaError_t; cudaErrorInvalidValue if a
// map cannot be encoded (a stride or base the TMA does not take).
template <int D, int kMode>
int launch_bthd_attention(const void* q, const void* k, const void* v, void* out, const float* kn,
                          float* lsum, int B, int Tq, int Tk, int H, BthdStrides qs,
                          BthdStrides ks, BthdStrides vs, float scale_log2, cudaStream_t stream) {
  constexpr int N = BthdTiles<D>::kBlockN;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bthd_map(&q_map, q, B, Tq, H, D, qs, kBthdBlockM) ||
      !encode_bthd_map(&k_map, k, B, Tk, H, D, ks, N) ||
      !encode_bthd_map(&v_map, v, B, Tk, H, D, vs, N))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = bthd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(bthd_attention_kernel<D, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBthdBlockM - 1) / kBthdBlockM, H, B);
  bthd_attention_kernel<D, kMode><<<grid, kBthdThreads, smem, stream>>>(
      q_map, k_map, v_map, out, kn, lsum, Tq, Tk, H, scale_log2);
  return (int)cudaGetLastError();
}


// --- Head dims above 256 (attention.cu): the wide variant of the loop
//
// Every multiple of 64 above 256, D a run-time argument; shared memory does
// not grow with D.
//
// * Slices of O. wgmma's N is at most 256 and a thread has at most 255
//   registers, so O (DV/2 registers a thread at 64 rows) is computed in as
//   few DV-wide column slices as the registers allow: one at D 320 (O 160
//   registers, P V as wgmma_rs<256> + wgmma_rs<64>), ceil(D / 256) above,
//   each 64 * ceil(D / 64 / slices) wide. So DV is 192, 256 or 320, the
//   kernel's one template parameter; columns of a last slice past D load as
//   zeros and are not stored. Each slice is a block that computes the full
//   logits Q K^T and O for its columns: D 512 computes Q K^T twice.
// * A block: 64 query rows, one consumer warpgroup and one producer
//   warpgroup (one thread issues every TMA load); 64-key tiles.
// * Q K^T is summed over D's 64-column boxes. K's boxes stream through a
//   ring of units (full / empty mbarriers), which wraps within and across
//   key tiles. Q's first `resident` boxes are loaded once a block; where Q
//   does not fit beside a ring of eight units, its other boxes ride in each
//   unit beside their K box, read again from L2 for every key tile.
// * The consumer waits for DV/64 boxes (as many as a slice has), issues them
//   as one commit group, and frees their units once it has finished; then
//   the rest of D's boxes one at a time. A group is retired before the loop
//   goes on, and no mbarrier wait sits between its products: either made
//   ptxas serialise every product (warning C7515).
// * V's slice (DV/64 boxes) has two stages of its own. O += P_{j-1} V_{j-1}
//   is issued once S_j is done, and the softmax of S_j runs under it.
//
// wide_plan (host) fills the 227 KB: 1 KB of mbarriers, V's two stages, all
// of Q if eight 8 KB units still fit beside it (at most 16 units), else four
// boxes of Q and eight 16 KB units (K and Q boxes):
//
//   D          slices x DV        resident Q boxes   units
//   320        1 x 320            5                  13 x 8 KB
//   384        2 x 192            6                  16 x 8 KB
//   448-768    2-3 x 256 (576:    7-12               13-8 x 8 KB
//              3 x 192)
//   832 up     ceil(D/256) x 256  4                  8 x 16 KB

constexpr int kSmemPerBlock = 232448;  // the H100's 227 KB a block
constexpr int kWideBox = 64 * 128;     // bytes of a box: 64 rows of 64 bf16 (Q, K or V)
constexpr int kWideMinUnits = 8;
constexpr int kWideMaxUnits = 16;

struct WidePlan {
  int slices, dv, resident, units, unit_bytes, smem;
};

inline WidePlan wide_plan(int D) {
  WidePlan p;
  const int nb = D / 64;
  p.slices = D <= 320 ? 1 : (D + 255) / 256;
  p.dv = 64 * ((nb + p.slices - 1) / p.slices);
  // boxes left beside V's two stages, 1 KB of mbarriers and 1 KB of slack to
  // align the dynamic base
  const int boxes = (kSmemPerBlock - 2048) / kWideBox - 2 * p.dv / 64;
  const bool all_of_q = nb + kWideMinUnits <= boxes;
  p.resident = all_of_q ? nb : boxes - 2 * kWideMinUnits;
  p.unit_bytes = (all_of_q ? 1 : 2) * kWideBox;
  p.units = (boxes - p.resident) * kWideBox / p.unit_bytes;
  if (p.units > kWideMaxUnits) p.units = kWideMaxUnits;
  p.smem = 2048 + (p.resident + 2 * p.dv / 64) * kWideBox + p.units * p.unit_bytes;
  return p;
}

struct WideBars {
  uint64_t q_full, v_full[2], v_empty[2], full[kWideMaxUnits], empty[kWideMaxUnits];
};
static_assert(sizeof(WideBars) <= 1024, "the wide variant's mbarriers take 1 KB");

// O += P V over the slice's DV columns: above 256, the first 256 columns and
// the rest (from V's fifth box on) as two products into the two parts of o.
template <int DV, int N>
__device__ __forceinline__ void wide_issue_pv(float (&o)[DV / 2], const uint32_t (&p)[N / 16][4],
                                              uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t desc = v_desc + kk * (2048 >> 4);
    if constexpr (DV <= 256) {
      wgmma_rs<DV>(o, p[kk], desc);
    } else {
      wgmma_rs<256>(reinterpret_cast<float(&)[128]>(o[0]), p[kk], desc);
      wgmma_rs<DV - 256>(reinterpret_cast<float(&)[(DV - 256) / 2]>(o[128]), p[kk],
                         desc + 4 * (N * 128 >> 4));
    }
  }
  wgmma_commit();
}

// out (B, Tq, H, D) bf16 contiguous, normalised by the row sum. Grid: 64-row
// query blocks x (H x slices) x B; blockIdx.y = h * slices + slice.
template <int DV>
__global__ void __launch_bounds__(256, 1)
bthd_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                 int Tq, int Tk, int H, int D, WidePlan plan, float scale_log2) {
  constexpr int N = 64;
  constexpr int kVBoxes = DV / 64;
  extern __shared__ __align__(128) uint8_t smem_raw[];  // aligned to 1024 below
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  WideBars& bars = *reinterpret_cast<WideBars*>(base);
  uint8_t* q_res = base + 1024;                      // Q's resident boxes
  uint8_t* v_st = q_res + plan.resident * kWideBox;  // V's two stages
  uint8_t* ring = v_st + 2 * kVBoxes * kWideBox;     // units: a K box [, its Q box]

  const int nb = D / 64;
  const int h = blockIdx.y / plan.slices;
  const int c0 = (blockIdx.y - h * plan.slices) * DV;  // the slice: O columns c0 .. c0 + DV - 1
  const int q0 = blockIdx.x * 64;
  const int b = blockIdx.z;
  const int n_tiles = (Tk + N - 1) / N;

  if (threadIdx.x == 0) {
    mbar_init(&bars.q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bars.v_full[s], 1);
      mbar_init(&bars.v_empty[s], 4);  // one arrival per consumer warp
    }
    for (int u = 0; u < plan.units; ++u) {
      mbar_init(&bars.full[u], 1);
      mbar_init(&bars.empty[u], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bars.q_full, plan.resident * kWideBox);
      for (int c = 0; c < plan.resident; ++c)
        tma_load(q_res + c * kWideBox, &q_map, &bars.q_full, 64 * c, h, q0, b);
      int u = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        for (int c = 0; c < nb; ++c) {
          mbar_wait(&bars.empty[u], phase ^ 1);  // the first round passes
          uint8_t* unit = ring + u * plan.unit_bytes;
          const bool q_box = c >= plan.resident;
          mbar_expect_tx(&bars.full[u], q_box ? 2 * kWideBox : kWideBox);
          tma_load(unit, &k_map, &bars.full[u], 64 * c, h, j * N, b);
          if (q_box) tma_load(unit + kWideBox, &q_map, &bars.full[u], 64 * c, h, q0, b);
          if (++u == plan.units) {
            u = 0;
            phase ^= 1;
          }
        }
        const int s = j & 1;
        mbar_wait(&bars.v_empty[s], ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(&bars.v_full[s], kVBoxes * kWideBox);
        for (int c = 0; c < kVBoxes; ++c)
          tma_load(v_st + (s * kVBoxes + c) * kWideBox, &v_map, &bars.v_full[s], c0 + 64 * c, h,
                   j * N, b);
      }
    }
    return;
  }

  const int tid = threadIdx.x - 128;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;

  float o[DV / 2];
  float acc[N / 2];
  uint32_t p[N / 16][4];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  Rows r;
  int u = 0;
  uint32_t phase = 0;
  mbar_wait(&bars.q_full, 0);

  // S_j = Q K_j^T over D's boxes: kVBoxes of them a commit group, then one
  // at a time (the header says why).
  uint64_t q_desc[kVBoxes], k_desc[kVBoxes];
  auto wait_box = [&](int c, int i) {  // box c's unit, its descriptors in slot i
    mbar_wait(&bars.full[u], phase);
    const uint8_t* unit = ring + u * plan.unit_bytes;
    q_desc[i] = smem_desc(c < plan.resident ? q_res + c * kWideBox : unit + kWideBox);
    k_desc[i] = smem_desc(unit);
    if (++u == plan.units) {
      u = 0;
      phase ^= 1;
    }
  };
  auto issue_box = [&](int c, int i) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<N>(acc, q_desc[i] + 2 * kk, k_desc[i] + 2 * kk, c + kk);
  };
  auto retire_boxes = [&](int first, int count) {  // then the group's units are free
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) {
      for (int i = 0; i < count; ++i) {
        mbar_arrive(&bars.empty[first]);
        if (++first == plan.units) first = 0;
      }
    }
  };

  for (int j = 0; j < n_tiles; ++j) {
    int c = 0;
    for (; c + kVBoxes <= nb; c += kVBoxes) {
      const int first = u;
#pragma unroll
      for (int i = 0; i < kVBoxes; ++i) wait_box(c + i, i);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kVBoxes; ++i) issue_box(c + i, i);
      retire_boxes(first, kVBoxes);
    }
    for (; c < nb; ++c) {
      const int first = u;
      wait_box(c, 0);
      wgmma_fence();
      issue_box(c, 0);
      retire_boxes(first, 1);
    }
    const int s = (j + 1) & 1;  // V_{j-1}'s stage
    if (j > 0) {
      mbar_wait(&bars.v_full[s], ((j - 1) >> 1) & 1);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      wide_issue_pv<DV, N>(o, p, smem_desc(v_st + s * kVBoxes * kWideBox, N * 128));
    }
    softmax_tile<N>(r, acc, j * N, Tk, t4, scale_log2);  // under P_{j-1} V_{j-1}
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (j > 0 && lane == 0) mbar_arrive(&bars.v_empty[s]);  // V_{j-1} consumed
    finish_tile<N, DV>(r, o, p, acc);
  }

  const int last = (n_tiles - 1) & 1;
  mbar_wait(&bars.v_full[last], ((n_tiles - 1) >> 1) & 1);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
  wide_issue_pv<DV, N>(o, p, smem_desc(v_st + last * kVBoxes * kWideBox, N * 128));
  wgmma_wait<0>();
  fence_regs(o);

  float l0 = r.l0, l1 = r.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  const int row_a = q0 + 16 * warp + (lane >> 2);
  const int row_b = row_a + 8;
  __nv_bfloat16* oa = out + (((size_t)b * Tq + row_a) * H + h) * D + c0 + 2 * t4;
  __nv_bfloat16* ob = oa + (size_t)8 * H * D;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    if (c0 + 8 * n >= D) continue;  // a last slice's columns past D
    if (row_a < Tq)
      *reinterpret_cast<uint32_t*>(oa + n * 8) = pack_float2(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (row_b < Tq)
      *reinterpret_cast<uint32_t*>(ob + n * 8) = pack_float2(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
}

// Encodes the three maps (64-row boxes) and launches the wide variant with
// slices of DV columns (plan = wide_plan(D), plan.dv == DV). Returns a
// cudaError_t.
template <int DV>
int launch_bthd_wide(const void* q, const void* k, const void* v, void* out, int B, int Tq,
                     int Tk, int H, int D, WidePlan plan, BthdStrides qs, BthdStrides ks,
                     BthdStrides vs, float scale_log2, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bthd_map(&q_map, q, B, Tq, H, D, qs, 64) ||
      !encode_bthd_map(&k_map, k, B, Tk, H, D, ks, 64) ||
      !encode_bthd_map(&v_map, v, B, Tk, H, D, vs, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bthd_wide_kernel<DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + 63) / 64, H * plan.slices, B);
  bthd_wide_kernel<DV><<<grid, 256, plan.smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), Tq, Tk, H, D, plan, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace pi3
