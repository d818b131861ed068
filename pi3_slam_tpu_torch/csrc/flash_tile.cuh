// The mma.sync attention tile loop of dots_attention.cu, the speed-of-light
// probe's dots-only kernel (kernel-table row 9; every other attention kernel
// runs the TMA + wgmma loops of packed_attention.cu and bthd_attention.cuh):
// one block of 4 warps owns 64 query rows of one head, each warp 16 rows, and
// walks the keys in 64-key tiles held in shared memory. Per tile: S = Q K^T
// (8 * D/16 mma.sync), P = bf16(S) in registers as the A operand, O += P V
// (4 * D/8 mma.sync), at head dim 64 (kD).
#pragma once

#include "mma.cuh"

namespace pi3 {

constexpr int kD = 64;        // head dim of the dots kernel
constexpr int kTile = 64;     // query rows per block, keys per tile
constexpr int kThreads = 128; // 4 warps x 16 query rows

// 64 rows of head dim D in shared memory, each row padded by 8 bf16
// (16 bytes) so that the fragment loads of neighbouring rows miss each
// other's banks: 144 bytes a row at D = 64.
template <int D>
using TileD = __nv_bfloat16[kTile][D + 8];
using Tile = TileD<kD>;

// rows [row0, row0+64) x 64 columns of a bf16 matrix whose rows start ld
// elements apart (16-byte aligned) -> smem; rows >= n_rows are zero-filled.
__device__ __forceinline__ void load_tile(Tile& dst, const __nv_bfloat16* src, long long ld,
                                          int row0, int n_rows) {
  constexpr int kShift = 3;  // log2 of the 16-byte chunks per row
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

}  // namespace pi3
