// mma.sync helpers of the 16-row attention cores: kernel 9's over a packed
// (rows, 3C) q|k|v buffer (head h in columns h*64 .. h*64+63 of each
// third), head dim 64, 4 warps per block, each warp owning 16 query rows,
// and the quad reductions of the softmax rows that kernel 2's GEMM epilogue
// and short-KV share. Logits arrive in base 2: the wrapper folds d^-0.5 *
// log2(e) into Wq, so the softmax uses exp2. fp32 softmax, P is rounded to
// bf16 for the P @ V product as in the reference kernels.
#pragma once

#include "common.cuh"

namespace mudg {

constexpr int AT_ROWS = 64;   // query rows (and key rows) per tile
constexpr int AT_LDS = 72;    // padded row of a 64-wide bf16 tile

// Copy a 64x64 tile (rows row0.., columns col0..) of a row-major bf16 matrix
// with leading dimension ld into shared memory.
__device__ __forceinline__ void load_tile64(bf16* dst, const bf16* src, size_t row0, int ld,
                                            int col0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + i * 128, r = c >> 3, col = (c & 7) * 8;
    *reinterpret_cast<uint4*>(dst + r * AT_LDS + col) =
        *reinterpret_cast<const uint4*>(src + (row0 + r) * (size_t)ld + col0 + col);
  }
}

// A fragments of this warp's 16 query rows over the 64 head dims.
__device__ __forceinline__ void load_q_frags(uint32_t qf[4][4], const bf16* qs,
                                             int warp, int g, int q) {
  const int r = warp * 16 + g;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    qf[ks][0] = lds32(qs + r * AT_LDS + ks * 16 + 2 * q);
    qf[ks][1] = lds32(qs + (r + 8) * AT_LDS + ks * 16 + 2 * q);
    qf[ks][2] = lds32(qs + r * AT_LDS + ks * 16 + 2 * q + 8);
    qf[ks][3] = lds32(qs + (r + 8) * AT_LDS + ks * 16 + 2 * q + 8);
  }
}

// s[nj] += Q(16 x 64) @ K^T over key rows key0 + nj*8 .. of the K tile.
template <int NF>
__device__ __forceinline__ void qk_logits(float s[NF][4], const uint32_t qf[4][4],
                                          const bf16* ks_tile, int key0, int g,
                                          int q) {
#pragma unroll
  for (int nj = 0; nj < NF; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nj][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int nj = 0; nj < NF; ++nj) {
      const bf16* kr = ks_tile + (key0 + nj * 8 + g) * AT_LDS + ks * 16 + 2 * q;
      const uint32_t b[2] = {lds32(kr), lds32(kr + 8)};
      mma_16816(s[nj], qf[ks], b);
    }
  }
}

// Two bf16 values packed as one mma operand register (a in the low half).
__device__ __forceinline__ uint32_t pack_pair(bf16 a, bf16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// A fragments (16 x 16) from the fp32 accumulator fragments of two adjacent
// 8-column blocks, rounded to bf16 (the accumulator layout is the A layout).
__device__ __forceinline__ void frag_from_acc(uint32_t a[4], const float lo[4],
                                              const float hi[4]) {
  a[0] = pack_bf16x2(lo[0], lo[1]);
  a[1] = pack_bf16x2(lo[2], lo[3]);
  a[2] = pack_bf16x2(hi[0], hi[1]);
  a[3] = pack_bf16x2(hi[2], hi[3]);
}

// acc[dj] += A(16 x 16*KK) @ T where T is rows row0.. row0+16*KK-1, columns
// 0..63 of a row-major shared tile (row stride AT_LDS): the B operand's k
// runs down the tile's rows, so each register takes two rows of one column.
template <int KK>
__device__ __forceinline__ void mma_rowmajor_b(float acc[8][4], const uint32_t a[KK][4],
                                               const bf16* tile, int row0, int g,
                                               int q) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) {
      const bf16* t = tile + (row0 + kk * 16 + 2 * q) * AT_LDS + dj * 8 + g;
      const uint32_t b[2] = {pack_pair(t[0], t[AT_LDS]),
                             pack_pair(t[8 * AT_LDS], t[9 * AT_LDS])};
      mma_16816(acc[dj], a[kk], b);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store this warp's 16 output rows (scaled per row) to out (rows, C).
__device__ __forceinline__ void store_o(bf16* out, int ldo, size_t row0,
                                       int col0, const float o[8][4],
                                       const float scale[2], int g, int q) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    bf16* orow = out + (row0 + g + hh * 8) * (size_t)ldo + col0;
#pragma unroll
    for (int dj = 0; dj < 8; ++dj)
      *reinterpret_cast<uint32_t*>(orow + dj * 8 + 2 * q) = pack_bf16x2(
          o[dj][2 * hh] * scale[hh], o[dj][2 * hh + 1] * scale[hh]);
  }
}

}  // namespace mudg
