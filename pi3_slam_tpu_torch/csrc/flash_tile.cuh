// The mma.sync online-softmax attention loop of dots_attention.cu (which runs
// it without its softmax) and of attention.cu's column-sliced kernel for head
// dims above 256 (packed_attention.cu and bthd_attention.cuh have the TMA +
// wgmma loop): one block of 4 warps owns 64 query rows of one head, each warp
// 16 rows, and walks the keys in 64-key tiles held in shared memory. Per
// tile: S = Q K^T (8 * D/16 mma.sync), base-2 online softmax on the S
// fragments (exact running max per row), P rounded to bf16 in registers as
// the A operand, O += P V (4 * D/8 mma.sync). The head dim D is a template
// parameter, 64 or 128; the dots kernel and the logits of the wide one take
// D = 64 (kD).
#pragma once

#include <math.h>

#include "mma.cuh"

namespace pi3 {

constexpr int kD = 64;        // head dim of the dots kernel and of the wide kernel's logits
constexpr int kTile = 64;     // query rows per block, keys per tile
constexpr int kThreads = 128; // 4 warps x 16 query rows

// 64 rows of head dim D in shared memory, each row padded by 8 bf16
// (16 bytes) so that the fragment loads of neighbouring rows miss each
// other's banks: 144 bytes a row at D = 64, 272 at D = 128.
template <int D>
using TileD = __nv_bfloat16[kTile][D + 8];
using Tile = TileD<kD>;

// rows [row0, row0+64) x D columns of a bf16 matrix whose rows start ld
// elements apart (16-byte aligned) -> smem; rows >= n_rows are zero-filled.
// LD = D + 8, the padded row of the tile.
template <int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (&dst)[kTile][LD],
                                          const __nv_bfloat16* src, long long ld, int row0,
                                          int n_rows) {
  constexpr int D = LD - 8;
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  constexpr int kShift = D == 64 ? 3 : 4;  // log2 of the 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile << kShift; i += kThreads) {
    const int r = i >> kShift;
    const int c = (i & ((1 << kShift) - 1)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ld + c);
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

// Per-thread state of the loop: this thread's rows are r0 = warp*16 + lane/4
// and r0 + 8 of the block's query tile.
template <int D>
struct FlashRows {
  float o[D / 8][4];       // O accumulator fragments (16 rows x D, fp32)
  float m0, m1;            // running max of the base-2 logits, rows r0 / r0+8
  float l0, l1;            // this thread's partial row sums of 2^(s - m)
};

// The A fragments of this thread's rows of a 64-row tile of Q (D columns).
template <int D>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[D / 16][4], const TileD<D>& Qs) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qf[kk][0] = ld_pair(&Qs[r0][c]);
    qf[kk][1] = ld_pair(&Qs[r0 + 8][c]);
    qf[kk][2] = ld_pair(&Qs[r0][c + 8]);
    qf[kk][3] = ld_pair(&Qs[r0 + 8][c + 8]);
  }
}

// O = 0, running max -inf, row sums 0.
template <int D>
__device__ __forceinline__ void reset_rows(FlashRows<D>& st) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
  st.m0 = st.m1 = -INFINITY;
  st.l0 = st.l1 = 0.f;
}

// s += Q K^T for this warp's 16 query rows and the tile's 64 keys: s[n] holds
// keys n*8 .. n*8+7 in the C fragment layout (D/16 mma.sync per 8 keys).
template <int D>
__device__ __forceinline__ void tile_logits(float (&s)[8][4], const uint32_t (&qf)[D / 16][4],
                                            const TileD<D>& Ks) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int key = n * 8 + g;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t4;
      mma_bf16_16816(s[n], qf[kk], ld_pair(&Ks[key][c]), ld_pair(&Ks[key][c + 8]));
    }
  }
}

// o += P V with P = bf16(s) (the tile's 64 keys) and V a 64-key tile of DV
// columns: the S accumulator layout of key tiles (2kk, 2kk+1) is the A
// operand layout of a 16-key step.
template <int DV>
__device__ __forceinline__ void tile_pv(float (&o)[DV / 8][4], const float (&s)[8][4],
                                        const TileD<DV>& Vs) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_float2(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_float2(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_float2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_float2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const int key = kk * 16 + 2 * t4;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = n * 8 + g;
      const uint32_t b0 = pack_pair(Vs[key][col], Vs[key + 1][col]);
      const uint32_t b1 = pack_pair(Vs[key + 8][col], Vs[key + 9][col]);
      mma_bf16_16816(o[n], pa, b0, b1);
    }
  }
}

// Base-2 online softmax of one tile's logits s (keys k0 .. k0+63; keys >=
// n_keys masked): scale by scale_log2, update the running max, s <- 2^(s - m),
// rescale O and the row sums. Key k0 < n_keys is in every visited tile, so the
// running max stays finite.
template <int D>
__device__ __forceinline__ void online_softmax(FlashRows<D>& st, float (&s)[8][4], int k0,
                                               int n_keys, float scale_log2) {
  const int t4 = threadIdx.x & 3;
  // scale to base-2 logits, mask keys >= n_keys, tile row max
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = k0 + n * 8 + 2 * t4 + j < n_keys;
      s[n][j] = ok ? s[n][j] * scale_log2 : -INFINITY;
      s[n][2 + j] = ok ? s[n][2 + j] * scale_log2 : -INFINITY;
      mx0 = fmaxf(mx0, s[n][j]);
      mx1 = fmaxf(mx1, s[n][2 + j]);
    }
  }
  // the four threads of a quad hold one row's 64 columns
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(st.m0, mx0);
  const float mn1 = fmaxf(st.m1, mx1);
  const float a0 = exp2f(st.m0 - mn0);  // 0 on the first tile (m = -inf)
  const float a1 = exp2f(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;

  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = exp2f(s[n][0] - mn0);
    s[n][1] = exp2f(s[n][1] - mn0);
    s[n][2] = exp2f(s[n][2] - mn1);
    s[n][3] = exp2f(s[n][3] - mn1);
    rs0 += s[n][0] + s[n][1];
    rs1 += s[n][2] + s[n][3];
  }
  st.l0 = st.l0 * a0 + rs0;
  st.l1 = st.l1 * a1 + rs1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= a0;
    st.o[n][1] *= a0;
    st.o[n][2] *= a1;
    st.o[n][3] *= a1;
  }
}

// Full row sums l0 / l1 (the quad's four partial sums added).
template <int D>
__device__ __forceinline__ void reduce_row_sums(FlashRows<D>& st) {
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 1);
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 2);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 1);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 2);
}

}  // namespace pi3
