// A warp-specialised, persistent bf16 GEMM for Hopper on TMA and wgmma, with
// fp32 accumulation and a fused epilogue:
//   out(M, N) = epilogue(A(M, K) @ B(N, K)^T),
// A and B row-major with K contiguous (B is the torch layout of a Linear
// weight (out, in), used as it is loaded).
//
// Epilogues (the output is bf16, except WG_F32's):
//   WG_BIAS      acc + bias[col] (a null bias is zero: the launcher points it
//                at WG_ZEROS zeros in device memory; a null test in the
//                epilogue, or an epilogue without the bias, made ptxas spill
//                ~600 bytes a thread at the 168-register cap)
//   WG_BIAS_RES  acc + bias[col] + res[row, col] (res read by TMA)
//   WG_GEGLU     u * gelu_erf(g), u = acc over B rows [n0, n0 + 64) +
//                bias[col], g = acc over B rows [gate + n0, ..) +
//                bias[gate + col]: each K slab of B holds the 64 value rows
//                and the 64 matching gate rows, one n128 product gives both
//                to the same thread, and only the (M, gate) product
//                u * gelu(g) reaches device memory.
//   WG_TATTN     kernel 2's attention as the epilogue of its q|k|v product:
//                a tile is 64 rows (four 16-row sequences) x the 192 B rows
//                [q_h | k_h | v_h] of one head h (the packing's head order);
//                each warp's accumulator rows are its own sequence, so it
//                rounds q, k and v to bf16 in registers, where q and k
//                already are mma.sync fragments and v becomes one by
//                movmatrix's 8x8 transposes, and runs the 16 x 16 base-2
//                softmax(q k^T) (normalised, rounded to bf16) times v; only
//                o_h (64 x 64, bf16) is stored, at column 64 h.
//   WG_GEGLU_BWD kernel 10's GEGLU backward: a tile is 64 rows x 64 columns
//                j of [u | g] (W1's value and gate rows of j, as WG_GEGLU)
//                and of dh = dy W2 (a second A operand, dy, against W2^T's
//                rows j, so dh never leaves the SM); the epilogue stores h =
//                u gelu(g) and [du | dg] in bf16, and the tile's fp32 column
//                sums of du and dg, added over its warps in a fixed order, as
//                one row of `part` (no atomics).
//   WG_TATTN_BWD kernel 9's attention backward as the epilogue of the q|k|v
//                product: WG_TATTN's tile, for which the producer also
//                loads the head's 64 x 64 slice of dO = dy Wo by TMA into
//                the warpgroup's dO box once its last epilogue has read it
//                (its own full and empty mbarriers); each warp re-forms its
//                sequence's P and o and forms
//                dP = dO v^T, dS = P (dP - rowsum(P dP)) ln 2, dq' = dS k,
//                dk = dS^T q' and dv = P^T dO with mma.sync in registers (q,
//                k, v, P, dS and dO transposed by movmatrix where an operand
//                needs it); o_h goes to column 64 h of `out`, [dq' | dk | dv]
//                to columns 192 h .. of `out2` (the packing's head order).
//   WG_F32       acc stored in fp32 from registers to `outf` (row pitch
//                ldo), no bias, no staging.
//
// Design: one block of 288 threads per SM walks output tiles of 128 rows x
// WG_TN columns (128, or 64 h columns for WG_GEGLU; tile t: row block t /
// n_tiles, column block t % n_tiles, so the blocks resident at one time
// share their A rows in L2). Warp 8 is the producer: one thread keeps a
// ring of STAGES K slabs in flight, each 64 columns of K (one 128-byte
// swizzle row of bf16) of the 128-row A tile and the 128-row B tile,
// loaded by TMA with one full and one empty mbarrier per stage. The two
// consumer warpgroups take alternate tiles of the block (ping-pong): each
// multiplies its tile's slabs by m64n128k16 wgmma (two 64-row halves, both
// operands from shared memory), one slab's products left in flight while
// the next slab is awaited; since the producer fills the ring in tile
// order, one warpgroup's products run while the other runs its epilogue
// (the GEGLU's erf is about 40% of the products' time at the tensor cores'
// peak, so it has to overlap them). The epilogue runs in registers; the
// warpgroup writes its 128-row result, swizzled, to its own staging tile
// in shared memory and one thread stores it with TMA as whole 128-byte rows
// (the residual arrives the same way, loaded when the tile starts). TMA's
// zero fill covers the K tail and the M and N tails of the loads, and its
// stores clip the M and N tails, so any M, any K % 8 == 0 and any N % 8 ==
// 0 run (N % 64 == 0 and gate % 64 == 0 for WG_GEGLU).
//
// Split tiles (WG_TATTN, WG_TATTN_BWD, WG_GEGLU_BWD): a consumer warpgroup's tile is 64
// rows whose 192 accumulator columns are one m64n128k16 and one m64n64k16
// product per k16 step, 96 fp32 registers a thread (a 128 x 192 tile would
// need 192, over the 168 that ptxas allots a thread of a 288-thread block).
// A stage holds the 64-row A slab (two, A and dy, for WG_GEGLU_BWD) and the
// tile's 192 B rows, each a 64-column K slab.
//
// Sources (where A, B and the output come from):
//   WG_MATRIX  row-major matrices through 2-D tensor maps, as above.
//   WG_TAP3    the (3, 1, 1) temporal convolution of a video h (B, T, HW,
//              C) as one GEMM with K = 3 taps x C: A's row r of frame (b,
//              t) over tap tau's C columns is h[b, t + tau - 1, r], B is the
//              packed weight wcat (C_out, 3, C_in). A comes through a 4-D map
//              (C, HW, T, B): a tile is 128 rows of HW inside one frame, and
//              for tap tau it loads frame t + tau - 1, which TMA fills with
//              zeros where it falls outside [0, T), so the zero fill is the
//              conv's padding and a tile never reads a neighbouring clip's
//              frame. B comes through a 3-D map (C_in, 3, C_out), so a tap's
//              last K slab at C_in % 64 != 0 is zero-filled and does not read
//              the next tap's columns. The output leaves through the 4-D map
//              of A's shape (the HW tail clipped on the store). Tiles walk
//              (b, t, HW block) with the column blocks innermost, so any HW
//              runs.
#pragma once

#include "hopper.cuh"

namespace mudg {

enum { WG_BIAS = 0, WG_BIAS_RES = 1, WG_GEGLU = 2, WG_TATTN = 3, WG_GEGLU_BWD = 4,
       WG_TATTN_BWD = 5, WG_F32 = 6 };
enum { WG_MATRIX = 0, WG_TAP3 = 1 };

constexpr int WG_BM = 128;                 // tile rows (64 for split tiles)
constexpr int WG_THREADS = 288;            // two consumer warpgroups + the producer warp
constexpr int WG_SLAB = 128 * 128;         // bytes of a 128-row K slab (of A or of B)
constexpr int WG_BOX = 64 * 128;           // bytes of a 64-row K slab

// 64-row tiles of 192 accumulator columns
__host__ __device__ constexpr bool wg_split(int epi) {
  return epi == WG_TATTN || epi == WG_TATTN_BWD || epi == WG_GEGLU_BWD;
}
// tiles whose B rows are one head's [q_h | k_h | v_h]
__host__ __device__ constexpr bool wg_tattn(int epi) {
  return epi == WG_TATTN || epi == WG_TATTN_BWD;
}
__host__ __device__ constexpr int wg_bm(int epi) { return wg_split(epi) ? 64 : WG_BM; }
// output columns of a tile
__host__ __device__ constexpr int wg_tn(int epi) {
  return epi == WG_BIAS || epi == WG_BIAS_RES || epi == WG_F32 ? 128 : 64;
}
// bytes of a stage's A slab(s), then of the whole stage (A and B)
__host__ __device__ constexpr int wg_a_bytes(int epi) {
  return epi == WG_GEGLU_BWD ? 2 * WG_BOX : wg_bm(epi) * 128;
}
__host__ __device__ constexpr int wg_stage(int epi) {
  return wg_a_bytes(epi) + (wg_split(epi) ? 192 * 128 : WG_SLAB);
}
__host__ __device__ constexpr int wg_stages(int epi) {
  return epi == WG_GEGLU_BWD || epi == WG_TATTN_BWD ? 4
         : epi == WG_GEGLU || epi == WG_TATTN        ? 6
                                                     : 5;
}
// bytes of a warpgroup's staging tile: the bf16 output tile; WG_GEGLU_BWD's
// h, du and dg boxes and its four warps' column sums (128 fp32 each);
// WG_TATTN_BWD's o, dq', dk and dv boxes and its dO box; none for WG_F32
__host__ __device__ constexpr int wg_staging(int epi) {
  return epi == WG_GEGLU_BWD   ? 3 * WG_BOX + 4 * 128 * 4
         : epi == WG_TATTN_BWD ? 5 * WG_BOX
         : epi == WG_F32       ? 0
                               : wg_bm(epi) * wg_tn(epi) * 2;
}
// the ring, two staging tiles, the barriers, and slack to align to 1024
__host__ __device__ constexpr int wg_smem(int epi) {
  return 1024 + wg_stages(epi) * wg_stage(epi) + 2 * wg_staging(epi) + 256;
}

struct WgGemmArgs {
  const float* bias;   // fp32: (N) or, for WG_GEGLU and WG_GEGLU_BWD, (2 * gate)
  int n;               // output columns (= gate for WG_GEGLU)
  int nk;              // 64-column K slabs per tile
  int gate;            // WG_GEGLU, WG_GEGLU_BWD: first B row of the gate half
  int n_tiles, tiles;  // column blocks, all tiles
  // WG_TAP3: frames per clip, 128-row tiles per frame, K slabs per tap
  int frames, hw_tiles, kc;
  float* part;         // WG_GEGLU_BWD: (row tiles, 2 * gate) column sums of du | dg
  float* outf;         // WG_F32: (m, n) fp32 output, row pitch ldo
  long long ldo;
  int m;
};

// The kernel's tensor maps (a __grid_constant__ parameter, so TMA reads them
// where they lie).
struct WgMaps {
  CUtensorMap a, b, out;
  CUtensorMap res;        // WG_BIAS_RES: the residual
  CUtensorMap a2, b2;     // WG_GEGLU_BWD: dy and W2^T; WG_TATTN_BWD: dO (a2)
  CUtensorMap out2;       // WG_GEGLU_BWD: [du | dg]; WG_TATTN_BWD: [dq' | dk | dv]
};

// Where tile t's rows lie: m0 for WG_MATRIX; the first row hw0 of HW, the
// frame t and the clip b for WG_TAP3 (row block mt = (b * T + t) *
// hw_tiles + hw0 / 128).
struct WgRows {
  int m0, hw0, t, b;
};

template <int SRC, int BM>
__device__ __forceinline__ WgRows wg_rows(const WgGemmArgs& p, int mt) {
  WgRows r;
  r.m0 = mt * BM;
  if (SRC == WG_TAP3) {
    const int frame = mt / p.hw_tiles;
    r.hw0 = (mt - frame * p.hw_tiles) * BM;
    r.t = frame % p.frames;
    r.b = frame / p.frames;
  }
  return r;
}

__device__ __forceinline__ float gelu_erf(float g) {
  return g * 0.5f * (1.f + erff(g * 0.70710678118654752f));
}

// WG_TATTN's epilogue on one warp's 16-row sequence (rows 16 warp .. + 15 of
// the tile; accumulator row g and g + 8 of this thread): q = acc columns
// 0-63, k = acc columns 64-127, v = acc2, each rounded to bf16; the base-2
// logits (the scale is in Wq), the softmax over the 16 keys in fp32 and
// normalised, P rounded to bf16 for P V, as the TPU kernel; o_h in bf16 to
// the staging tile (64 x 64, swizzled).
__device__ __forceinline__ void wg_tattn_epilogue(const float (&acc)[64], const float (&acc2)[32],
                                                  uint8_t* stg, int warp, int g, int qd) {
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) acc_to_a(qf[ks], acc, ks);
  float s[2][4];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    // key 8 nb + g is this thread's accumulator row g + 8 nb; its dims 16 ks
    // + 2 qd (+ 8) are k's column blocks j = 8 + 2 ks (+ 1)
    const int j = 8 + 2 * ks;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const uint32_t b[2] = {pack_bf16x2(acc[4 * j + 2 * nb], acc[4 * j + 2 * nb + 1]),
                             pack_bf16x2(acc[4 * j + 4 + 2 * nb], acc[4 * j + 5 + 2 * nb])};
      mma_16816(s[nb], qf[ks], b);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float mx = quad_max(fmaxf(fmaxf(s[0][2 * hh], s[0][2 * hh + 1]),
                                    fmaxf(s[1][2 * hh], s[1][2 * hh + 1])));
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      s[nb][2 * hh] = exp2f(s[nb][2 * hh] - mx);
      s[nb][2 * hh + 1] = exp2f(s[nb][2 * hh + 1] - mx);
      sum += s[nb][2 * hh] + s[nb][2 * hh + 1];
    }
    const float inv = 1.f / quad_sum(sum);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      s[nb][2 * hh] *= inv;
      s[nb][2 * hh + 1] *= inv;
    }
  }
  // P (16 queries x 16 keys) as an A fragment: the logits' accumulator layout
  const uint32_t pa[4] = {pack_bf16x2(s[0][0], s[0][1]), pack_bf16x2(s[0][2], s[0][3]),
                          pack_bf16x2(s[1][0], s[1][1]), pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) {
    // v's 8x8 blocks (keys 0-7 and 8-15, dims 8 dj ..) transposed: the B
    // fragment (k = key, n = dim)
    const uint32_t b[2] = {movmatrix_trans(pack_bf16x2(acc2[4 * dj], acc2[4 * dj + 1])),
                           movmatrix_trans(pack_bf16x2(acc2[4 * dj + 2], acc2[4 * dj + 3]))};
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    mma_16816(o, pa, b);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(stg + sw128_offset(16 * warp + g + 8 * hh, 8 * dj + 2 * qd, 64)) =
          pack_bf16x2(o[2 * hh], o[2 * hh + 1]);
  }
}

constexpr float WG_LN2 = 0.6931471805599453f;

// WG_TATTN_BWD's epilogue on one warp's 16-row sequence (kernel 9's
// numerics, temporal_attn.py:265-369): q', k and v = acc columns 0-63,
// 64-127 and acc2, each rounded to bf16; P the normalised base-2 softmax of
// q' k^T in fp32; o = P_bf16 v; dP = dO v^T (dO bf16 from the warpgroup's
// box `sdo`); dS = P (dP - rowsum(P dP)) ln 2 rounded to bf16; dq' = dS k,
// dk = dS^T q', dv = P_bf16^T dO; o, dq', dk and dv rounded to bf16 into
// the staging boxes 0-3 (64 x 64 each, swizzled).
// q', k and v first go to boxes 1-3 (the accumulators' 96 registers are then
// free: held in registers through the epilogue they made ptxas spill at the
// 168-register cap) and each thread reads back only the positions it wrote:
// its 8x8 blocks as the accumulator lays them out (rows g and g + 8 of the
// sequence, columns 8 j + 2 qd, + 1). Such a block is an mma.sync A
// fragment over the columns, or a B fragment over them where its rows are
// the n index; movmatrix's transpose gives the B fragment where its rows
// are the k index (v, k and q' as the right operand of P v, dS k and dS^T
// q'), and the A fragments of P^T and dS^T. Column block j of dq', dk and
// dv overwrites q', k and v there after the thread's last read of it.
__device__ __forceinline__ void wg_tattn_bwd_epilogue(const float (&acc)[64],
                                                      const float (&acc2)[32],
                                                      const uint8_t* sdo, uint8_t* stg, int warp,
                                                      int g, int qd) {
  const int r = 16 * warp + g;
  // this thread's bf16 pair at (row, column c) of staging box `box`
  auto at = [&](int box, int row, int c) {
    return reinterpret_cast<uint32_t*>(stg + box * WG_BOX + sw128_offset(row, c, 64));
  };
  auto dat = [&](int row, int c) {
    return *reinterpret_cast<const uint32_t*>(sdo + sw128_offset(row, c, 64));
  };
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = 8 * j + 2 * qd;
      *at(1, r + 8 * hh, c) = pack_bf16x2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      *at(2, r + 8 * hh, c) = pack_bf16x2(acc[4 * (j + 8) + 2 * hh], acc[4 * (j + 8) + 2 * hh + 1]);
      *at(3, r + 8 * hh, c) = pack_bf16x2(acc2[4 * j + 2 * hh], acc2[4 * j + 2 * hh + 1]);
    }
  // S = q' k^T and dP = dO v^T over the 16 keys (key block nb: keys 8 nb ..)
  float s[2][4], dp[2][4];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = 16 * ks + 2 * qd;
    const uint32_t qa[4] = {*at(1, r, c), *at(1, r + 8, c), *at(1, r, c + 8), *at(1, r + 8, c + 8)};
    const uint32_t da_o[4] = {dat(r, c), dat(r + 8, c), dat(r, c + 8), dat(r + 8, c + 8)};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const uint32_t kb[2] = {*at(2, r + 8 * nb, c), *at(2, r + 8 * nb, c + 8)};
      const uint32_t vb[2] = {*at(3, r + 8 * nb, c), *at(3, r + 8 * nb, c + 8)};
      mma_16816(s[nb], qa, kb);
      mma_16816(dp[nb], da_o, vb);
    }
  }
  uint32_t pa[4], da[4];   // P (bf16) and dS (bf16) as A fragments over the keys
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float mx = quad_max(fmaxf(fmaxf(s[0][2 * hh], s[0][2 * hh + 1]),
                                    fmaxf(s[1][2 * hh], s[1][2 * hh + 1])));
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nb][2 * hh + e] = exp2f(s[nb][2 * hh + e] - mx);
        sum += s[nb][2 * hh + e];
      }
    const float inv = 1.f / quad_sum(sum);
    float pdp = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nb][2 * hh + e] *= inv;
        pdp += s[nb][2 * hh + e] * dp[nb][2 * hh + e];
      }
    pdp = quad_sum(pdp);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const float* pn = s[nb] + 2 * hh;
      const float* dn = dp[nb] + 2 * hh;
      pa[2 * nb + hh] = pack_bf16x2(pn[0], pn[1]);
      da[2 * nb + hh] = pack_bf16x2(pn[0] * (dn[0] - pdp) * WG_LN2, pn[1] * (dn[1] - pdp) * WG_LN2);
    }
  }
  // P^T and dS^T as A fragments over the queries: block (keys, queries) of
  // the transpose is the transpose of block (queries, keys)
  const uint32_t pt[4] = {movmatrix_trans(pa[0]), movmatrix_trans(pa[2]),
                          movmatrix_trans(pa[1]), movmatrix_trans(pa[3])};
  const uint32_t dt[4] = {movmatrix_trans(da[0]), movmatrix_trans(da[2]),
                          movmatrix_trans(da[1]), movmatrix_trans(da[3])};
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) {
    // B fragments over head dims 8 dj ..: v, k, q' and dO with their rows
    // (keys or queries) as k
    const int c = 8 * dj + 2 * qd;
    const uint32_t vb[2] = {movmatrix_trans(*at(3, r, c)), movmatrix_trans(*at(3, r + 8, c))};
    const uint32_t kb[2] = {movmatrix_trans(*at(2, r, c)), movmatrix_trans(*at(2, r + 8, c))};
    const uint32_t qb[2] = {movmatrix_trans(*at(1, r, c)), movmatrix_trans(*at(1, r + 8, c))};
    const uint32_t db[2] = {movmatrix_trans(dat(r, c)), movmatrix_trans(dat(r + 8, c))};
    float out[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[i][e] = 0.f;
    mma_16816(out[0], pa, vb);   // o = P v
    mma_16816(out[1], da, kb);   // dq' = dS k
    mma_16816(out[2], dt, qb);   // dk = dS^T q'
    mma_16816(out[3], pt, db);   // dv = P^T dO
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *at(i, r + 8 * hh, c) = pack_bf16x2(out[i][2 * hh], out[i][2 * hh + 1]);
  }
}

// WG_GEGLU_BWD's epilogue: u = acc columns 0-63 + b1, g = acc columns
// 64-127 + the gate's b1, dh = acc2, all fp32 (mlp.py:341-385): h = u
// gelu(g), du = dh gelu(g), dg = dh u (Phi(g) + g pdf(g)); h, du and dg
// rounded to bf16 into the staging boxes, and this warp's column sums of
// the fp32 du and dg over its 16 rows to sums[warp][0..127].
__device__ __forceinline__ void wg_geglu_bwd_epilogue(const float (&acc)[64],
                                                      const float (&acc2)[32],
                                                      const WgGemmArgs& p, int n0, uint8_t* stg,
                                                      float* sums, int warp, int g, int qd) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * qd;
    const float2 bu = *reinterpret_cast<const float2*>(p.bias + n0 + c);
    const float2 bg = *reinterpret_cast<const float2*>(p.bias + p.gate + n0 + c);
    float su[2] = {0.f, 0.f}, sg[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float h[2], du[2], dg[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float u = acc[4 * j + 2 * hh + e] + (e ? bu.y : bu.x);
        const float gt = acc[4 * (j + 8) + 2 * hh + e] + (e ? bg.y : bg.x);
        const float dh = acc2[4 * j + 2 * hh + e];
        const float phi = 0.5f * (1.f + erff(gt * 0.70710678118654752f));
        const float pdf = expf(-0.5f * gt * gt) * 0.3989422804014327f;
        const float gelu = gt * phi;
        h[e] = u * gelu;
        du[e] = dh * gelu;
        dg[e] = dh * u * (phi + gt * pdf);
        su[e] += du[e];
        sg[e] += dg[e];
      }
      const int r = 16 * warp + g + 8 * hh;
      *reinterpret_cast<uint32_t*>(stg + sw128_offset(r, c, 64)) = pack_bf16x2(h[0], h[1]);
      *reinterpret_cast<uint32_t*>(stg + WG_BOX + sw128_offset(r, c, 64)) =
          pack_bf16x2(du[0], du[1]);
      *reinterpret_cast<uint32_t*>(stg + WG_BOX + sw128_offset(r, 64 + c, 64)) =
          pack_bf16x2(dg[0], dg[1]);
    }
    // lanes of one qd hold the same columns: sum over g (lane bits 2-4)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        su[e] += __shfl_xor_sync(0xffffffffu, su[e], off);
        sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], off);
      }
    if (g == 0) {
      *reinterpret_cast<float2*>(sums + warp * 128 + c) = make_float2(su[0], su[1]);
      *reinterpret_cast<float2*>(sums + warp * 128 + 64 + c) = make_float2(sg[0], sg[1]);
    }
  }
}

// The consumers of split tiles: warpgroup cw takes the block's tiles i = cw,
// cw + 2, .. in turns with the other (as the kernel's other consumers).
template <int EPI>
__device__ __forceinline__ void wg_split_consumer(uint8_t* ring, uint8_t* staging,
                                                  uint64_t* full, uint64_t* empty,
                                                  uint64_t* do_full, uint64_t* do_empty,
                                                  const WgMaps& maps, const WgGemmArgs& p) {
  constexpr int S = wg_stages(EPI), STAGE = wg_stage(EPI), A_BYTES = wg_a_bytes(EPI);
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  uint8_t* stg = staging + cw * wg_staging(EPI);
  float* sums = reinterpret_cast<float*>(stg + 3 * WG_BOX);   // WG_GEGLU_BWD
  uint8_t* sdo = stg + 4 * WG_BOX;                             // WG_TATTN_BWD
  const int nk = p.nk;
  const int ntiles = (p.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  float acc[64], acc2[32];   // B rows 0-127 and 128-191 of the tile
  if (cw == 1) named_bar_arrive(3, 256);   // warpgroup 0 takes tile 0 at once
  for (int i = cw; i < ntiles; i += 2) {
    const int t = blockIdx.x + i * gridDim.x;
    named_bar_sync(3 + cw, 256);
    const int mt = t / p.n_tiles, m0 = mt * 64, n0 = (t % p.n_tiles) * 64;
    int it = i * nk, prev = 0;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      if (ks == nk - 1) named_bar_arrive(4 - cw, 256);   // the other's turn to wait
      uint8_t* st = ring + s * STAGE;
      // the n64 product's A: the stage's last A slab (dy for WG_GEGLU_BWD)
      const uint64_t da = sw128_desc(st), da2 = sw128_desc(st + A_BYTES - WG_BOX);
      const uint64_t db = sw128_desc(st + A_BYTES);
      fence_regs(acc);
      fence_regs(acc2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n128(acc, da + kk * KMAJOR_K16, db + kk * KMAJOR_K16, ks > 0 || kk > 0);
        wgmma_ss_n64(acc2, da2 + kk * KMAJOR_K16, db + (WG_SLAB >> 4) + kk * KMAJOR_K16,
                     ks > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slab's products are done: its stage is free
      fence_regs(acc);
      fence_regs(acc2);
      if (ks > 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(acc2);
    mbar_arrive(&empty[prev]);

    // epilogue: registers -> staging (swizzled) -> TMA store
    if (tid == 0) bulk_wait_read<0>();
    named_bar_sync(1 + cw, 128);
    if constexpr (EPI == WG_TATTN) {
      wg_tattn_epilogue(acc, acc2, stg, warp, g, qd);
    } else if constexpr (EPI == WG_TATTN_BWD) {
      mbar_wait(&do_full[cw], (i / 2) & 1);
      wg_tattn_bwd_epilogue(acc, acc2, sdo, stg, warp, g, qd);
    } else {
      wg_geglu_bwd_epilogue(acc, acc2, p, n0, stg, sums, warp, g, qd);
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);
    if (tid == 0) {
      tma_store_2d(&maps.out, stg, n0, m0);   // o_h at column 64 h; h
      if (EPI == WG_GEGLU_BWD) {
        tma_store_2d(&maps.out2, stg + WG_BOX, n0, m0);                  // du
        tma_store_2d(&maps.out2, stg + 2 * WG_BOX, p.gate + n0, m0);     // dg
      } else if (EPI == WG_TATTN_BWD) {   // dq', dk, dv at columns 192 h ..
        for (int bx = 1; bx < 4; ++bx)
          tma_store_2d(&maps.out2, stg + bx * WG_BOX, 3 * n0 + 64 * (bx - 1), m0);
        mbar_arrive(&do_empty[cw]);   // every thread has read the dO box
      }
      bulk_commit();
    }
    if (EPI == WG_GEGLU_BWD) {   // the tile's column sums, warps added in order
      const float v = ((sums[tid] + sums[128 + tid]) + sums[256 + tid]) + sums[384 + tid];
      const int col = tid < 64 ? n0 + tid : p.gate + n0 + tid - 64;
      p.part[(size_t)mt * 2 * p.gate + col] = v;
    }
  }
  // the other warpgroup's arrival after its last tile, where no tile of
  // this one took it
  if (cw == 0 && ntiles % 2 == 0) named_bar_sync(3, 256);
  if (cw == 1 && ntiles % 2 == 1) named_bar_sync(4, 256);
  if (tid == 0) bulk_wait<0>();
}

template <int EPI, int SRC>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_gemm_kernel(const __grid_constant__ WgMaps maps, const WgGemmArgs p) {
  constexpr int S = wg_stages(EPI), TN = wg_tn(EPI), BM = wg_bm(EPI), STAGE = wg_stage(EPI);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint8_t* staging = ring + S * STAGE;   // per consumer warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * wg_staging(EPI));
  uint64_t* empty = full + S;
  uint64_t* res_bar = empty + S;      // per consumer warpgroup (WG_TATTN_BWD: dO full)
  uint64_t* do_empty = res_bar + 2;   // WG_TATTN_BWD: per consumer warpgroup, dO box read
  const int nk = p.nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);   // a stage is read by the warpgroup of its tile
    }
    mbar_init(&res_bar[0], 1);
    mbar_init(&res_bar[1], 1);
    mbar_init(&do_empty[0], 1);
    mbar_init(&do_empty[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer: every tile's slabs, in tile order
    if (threadIdx.x == 256) {
      int it = 0, ti = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++ti) {
        const WgRows rw = wg_rows<SRC, BM>(p, t / p.n_tiles);
        const int n0 = (t % p.n_tiles) * TN;
        if (EPI == WG_TATTN_BWD) {   // the head's dO slice, into its warpgroup's dO box
          const int cw = ti & 1, jw = ti >> 1;
          if (jw > 0) mbar_wait(&do_empty[cw], (jw - 1) & 1);
          mbar_expect_tx(&res_bar[cw], WG_BOX);
          tma_load_2d(staging + cw * wg_staging(EPI) + 4 * WG_BOX, &maps.a2, &res_bar[cw], n0,
                      rw.m0);
        }
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
          uint8_t* st = ring + s * STAGE;
          uint8_t* sb = st + wg_a_bytes(EPI);
          mbar_expect_tx(&full[s], STAGE);
          if (SRC == WG_TAP3) {   // tap tau = ks / kc reads frame t + tau - 1
            const int tap = ks / p.kc, k0 = (ks - tap * p.kc) * 64;
            tma_load_4d(st, &maps.a, &full[s], k0, rw.hw0, rw.t + tap - 1, rw.b);
            tma_load_3d(sb, &maps.b, &full[s], k0, tap, n0);
            continue;
          }
          tma_load_2d(st, &maps.a, &full[s], ks * 64, rw.m0);
          if (wg_tattn(EPI)) {   // the head's 192 rows [q_h | k_h | v_h]
            tma_load_2d(sb, &maps.b, &full[s], ks * 64, 3 * n0);
          } else if (EPI == WG_GEGLU_BWD) {   // dy; W1's value and gate rows, W2^T's
            tma_load_2d(st + WG_BOX, &maps.a2, &full[s], ks * 64, rw.m0);
            tma_load_2d(sb, &maps.b, &full[s], ks * 64, n0);
            tma_load_2d(sb + WG_BOX, &maps.b, &full[s], ks * 64, p.gate + n0);
            tma_load_2d(sb + 2 * WG_BOX, &maps.b2, &full[s], ks * 64, n0);
          } else if (EPI == WG_GEGLU) {   // 64 value rows, then the 64 gate rows
            tma_load_2d(sb, &maps.b, &full[s], ks * 64, n0);
            tma_load_2d(sb + WG_SLAB / 2, &maps.b, &full[s], ks * 64, p.gate + n0);
          } else {
            tma_load_2d(sb, &maps.b, &full[s], ks * 64, n0);
          }
        }
      }
    }
    return;
  }

  if constexpr (wg_split(EPI)) {
    wg_split_consumer<EPI>(ring, staging, full, empty, res_bar, do_empty, maps, p);
  } else {
    // consumers: warpgroup cw takes the block's tiles i = cw, cw + 2, ..
    // A warpgroup waits for a tile's slabs only once the other has waited
    // for all of the previous tile's (named barriers 3 and 4, in turns): a
    // wait on an mbarrier more than one phase ahead of it would pass at once.
    const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    uint8_t* stg = staging + cw * wg_staging(EPI);
    const int ntiles = (p.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    float acc[2][64];   // rows 0-63 and 64-127 of the tile
    if (cw == 1) named_bar_arrive(3, 256);   // warpgroup 0 takes tile 0 at once
    int j = 0;
    for (int i = cw; i < ntiles; i += 2, ++j) {
      const int t = blockIdx.x + i * gridDim.x;
      named_bar_sync(3 + cw, 256);
      const WgRows rw = wg_rows<SRC, BM>(p, t / p.n_tiles);
      const int n0 = (t % p.n_tiles) * TN;
      // 64-column boxes of this tile that hold output columns (N tail)
      const int boxes = min(TN / 64, (p.n - n0 + 63) / 64);
      if (EPI == WG_BIAS_RES && tid == 0) {
        // the staging tile is free once the last store has read it; the
        // residual lands there while the products run
        bulk_wait_read<0>();
        mbar_expect_tx(&res_bar[cw], boxes * WG_BM * 128);
        for (int bx = 0; bx < boxes; ++bx)
          tma_load_2d(stg + bx * WG_BM * 128, &maps.res, &res_bar[cw], n0 + 64 * bx, rw.m0);
      }

      int it = i * nk, prev = 0;
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        if (ks == nk - 1) named_bar_arrive(4 - cw, 256);   // the other's turn to wait
        uint8_t* st = ring + s * STAGE;
        const uint64_t da = sw128_desc(st), db = sw128_desc(st + WG_SLAB);
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int hm = 0; hm < 2; ++hm)
            wgmma_ss_n128(acc[hm], da + (hm * 64 * 128 >> 4) + kk * KMAJOR_K16,
                          db + kk * KMAJOR_K16, ks > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous slab's products are done: its stage is free
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        if (ks > 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      mbar_arrive(&empty[prev]);

      if constexpr (EPI == WG_F32) {   // fp32 from registers, tails clipped
#pragma unroll
        for (int hm = 0; hm < 2; ++hm)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = rw.m0 + 64 * hm + 16 * warp + g + 8 * hh;
            if (row >= p.m) continue;
            float* orow = p.outf + row * p.ldo + n0 + 2 * qd;
#pragma unroll
            for (int jj = 0; jj < TN / 8; ++jj)
              if (n0 + 8 * jj + 2 * qd < p.n)
                *reinterpret_cast<float2*>(orow + 8 * jj) =
                    make_float2(acc[hm][4 * jj + 2 * hh], acc[hm][4 * jj + 2 * hh + 1]);
          }
        continue;
      }

      // epilogue: registers -> staging (swizzled) -> TMA store
      if (EPI != WG_BIAS_RES && tid == 0) bulk_wait_read<0>();
      named_bar_sync(1 + cw, 128);
      if (EPI == WG_BIAS_RES) mbar_wait(&res_bar[cw], j & 1);
      // column pair (c, c + 1) of this thread, its biases read once for the
      // four rows that hold it
#pragma unroll
      for (int jj = 0; jj < TN / 8; ++jj) {
        const int c = 8 * jj + 2 * qd, col = n0 + c;
        const bool live = EPI == WG_GEGLU || col < p.n;
        const float2 bv = live ? *reinterpret_cast<const float2*>(p.bias + col)
                               : make_float2(0.f, 0.f);
        float2 bg = make_float2(0.f, 0.f);
        if (EPI == WG_GEGLU) bg = *reinterpret_cast<const float2*>(p.bias + p.gate + col);
#pragma unroll
        for (int hm = 0; hm < 2; ++hm) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 64 * hm + 16 * warp + g + 8 * hh;
            uint32_t* dst = reinterpret_cast<uint32_t*>(stg + sw128_offset(r, c, WG_BM));
            float v0 = acc[hm][4 * jj + 2 * hh] + bv.x, v1 = acc[hm][4 * jj + 2 * hh + 1] + bv.y;
            if (EPI == WG_GEGLU) {   // the gate of column c is accumulator column 64 + c
              v0 *= gelu_erf(acc[hm][4 * (jj + 8) + 2 * hh] + bg.x);
              v1 *= gelu_erf(acc[hm][4 * (jj + 8) + 2 * hh + 1] + bg.y);
            } else if (EPI == WG_BIAS_RES && live) {
              const float2 x = unpack_bf16x2(*dst);
              v0 += x.x;
              v1 += x.y;
            }
            *dst = pack_bf16x2(v0, v1);
          }
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);
      if (tid == 0) {
        for (int bx = 0; bx < boxes; ++bx) {
          if (SRC == WG_TAP3)
            tma_store_4d(&maps.out, stg + bx * WG_BM * 128, n0 + 64 * bx, rw.hw0, rw.t, rw.b);
          else
            tma_store_2d(&maps.out, stg + bx * WG_BM * 128, n0 + 64 * bx, rw.m0);
        }
        bulk_commit();
      }
    }
    // the other warpgroup's arrival after its last tile, where no tile of
    // this one took it
    if (cw == 0 && ntiles % 2 == 0) named_bar_sync(3, 256);
    if (cw == 1 && ntiles % 2 == 1) named_bar_sync(4, 256);
    if (tid == 0) bulk_wait<0>();
  }
}

// The bias of a WG_BIAS product without one.
constexpr int WG_ZEROS = 4096;
static __device__ float wg_zeros[WG_ZEROS] = {};

// Launches the kernel on persistent blocks, one per SM or one per tile
// where there are fewer tiles; p.tiles and p.n_tiles set.
template <int EPI, int SRC>
static inline cudaError_t wg_launch(const WgMaps& maps, const WgGemmArgs& p,
                                    cudaStream_t stream) {
  // the dynamic shared-memory limit is raised once per host thread (a
  // launch from a thread that has not raised it is refused)
  thread_local bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(wgmma_gemm_kernel<EPI, SRC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wg_smem(EPI));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int sms = mudg_host::sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int grid = p.tiles < sms ? p.tiles : sms;
  wgmma_gemm_kernel<EPI, SRC><<<grid, WG_THREADS, wg_smem(EPI), stream>>>(maps, p);
  return cudaGetLastError();
}

template <int EPI, int SRC>
static inline cudaError_t wg_launch(const CUtensorMap& ta, const CUtensorMap& tb,
                                    const CUtensorMap& tout, const CUtensorMap& tres,
                                    const WgGemmArgs& p, cudaStream_t stream) {
  WgMaps maps;
  maps.a = maps.a2 = ta;
  maps.b = maps.b2 = tb;
  maps.out = maps.out2 = tout;
  maps.res = tres;
  return wg_launch<EPI, SRC>(maps, p, stream);
}

// out = epilogue(A @ B^T). a: (m, k) with row pitch lda, b: (rows_b, k)
// with pitch ldb (rows_b = n, or 2 * gate for WG_GEGLU), out: (m, n) with
// pitch ldo, res: (m, n) with pitch ldr (WG_BIAS_RES); bias null for none
// (WG_BIAS, n <= WG_ZEROS). Pitches are multiples of 8 elements, pointers
// 16-byte aligned.
template <int EPI>
static inline cudaError_t launch_wgmma_gemm(const bf16* a, long long lda, const bf16* b,
                                            long long ldb, bf16* out, long long ldo,
                                            const bf16* res, long long ldr, const float* bias,
                                            int m, int n, int k, int gate,
                                            cudaStream_t stream) {
  using mudg_host::bf16_matrix_map;
  const bool geglu = EPI == WG_GEGLU;
  CUtensorMap ta, tb, tout, tres;
  cudaError_t e = bf16_matrix_map(&ta, a, m, k, lda, WG_BM);
  if (e == cudaSuccess) e = bf16_matrix_map(&tb, b, geglu ? 2 * gate : n, k, ldb, geglu ? 64 : 128);
  if (e == cudaSuccess) e = bf16_matrix_map(&tout, out, m, n, ldo, WG_BM);
  if (e == cudaSuccess) e = bf16_matrix_map(&tres, res != nullptr ? res : out, m, n,
                                            res != nullptr ? ldr : ldo, WG_BM);
  if (e != cudaSuccess) return e;
  if (bias == nullptr) {   // the current device's copy of wg_zeros
    if (EPI != WG_BIAS || n > WG_ZEROS) return cudaErrorInvalidValue;
    void* zeros = nullptr;
    e = cudaGetSymbolAddress(&zeros, wg_zeros);
    if (e != cudaSuccess) return e;
    bias = static_cast<const float*>(zeros);
  }
  WgGemmArgs p = {};
  p.bias = bias;
  p.n = n;
  p.nk = (k + 63) / 64;
  p.gate = gate;
  p.n_tiles = (n + wg_tn(EPI) - 1) / wg_tn(EPI);
  p.tiles = ((m + WG_BM - 1) / WG_BM) * p.n_tiles;
  return wg_launch<EPI, WG_MATRIX>(ta, tb, tout, tres, p, stream);
}

// Kernel 2's q|k|v product with its attention as the epilogue (WG_TATTN):
// o[:, 64 h ..] = softmax(q_h k_h^T) v_h over each 16-row sequence, q_h |
// k_h | v_h = xn Wqkv'[192 h .., :]^T. xn, o: (rows, c) bf16; wqkv: (3c,
// c) bf16 in head order, rows 192 h .. 192 h + 191 = [Wq'_h | Wk_h | Wv_h],
// Wq' carrying d^-0.5 * log2(e). rows % 64 == 0 (a tile never splits a
// sequence), c % 64 == 0.
static inline cudaError_t launch_wgmma_tattn(const bf16* xn, const bf16* wqkv, bf16* o,
                                             int rows, int c, cudaStream_t stream) {
  using mudg_host::bf16_matrix_map;
  if (rows % 64 || c % 64) return cudaErrorInvalidValue;
  WgMaps maps;
  cudaError_t e = bf16_matrix_map(&maps.a, xn, rows, c, c, 64);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.b, wqkv, 3LL * c, c, c, 192);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.out, o, rows, c, c, 64);
  if (e != cudaSuccess) return e;
  maps.a2 = maps.res = maps.a;
  maps.b2 = maps.b;
  maps.out2 = maps.out;
  WgGemmArgs p = {};
  p.n = c;
  p.nk = c / 64;
  p.n_tiles = c / 64;   // heads
  p.tiles = rows / 64 * p.n_tiles;
  return wg_launch<WG_TATTN, WG_MATRIX>(maps, p, stream);
}

// Kernel 9's attention backward as the epilogue of the q|k|v product
// (WG_TATTN_BWD): per 64-row tile and head h, q'_h | k_h | v_h = xn
// Wqkv'[192 h .., :]^T recomputed, then o[:, 64 h ..] and dqkv[:, 192 h ..] =
// [dq'_h | dk_h | dv_h] from dout[:, 64 h ..] (dO = dy Wo). xn, dout, o:
// (rows, c) bf16; wqkv (3c, c) bf16 in head order (as launch_wgmma_tattn);
// dqkv (rows, 3c) bf16 in the same head order. rows % 64 == 0, c % 64 == 0.
static inline cudaError_t launch_wgmma_tattn_bwd(const bf16* xn, const bf16* wqkv,
                                                 const bf16* dout, bf16* o, bf16* dqkv,
                                                 int rows, int c, cudaStream_t stream) {
  using mudg_host::bf16_matrix_map;
  if (rows % 64 || c % 64) return cudaErrorInvalidValue;
  WgMaps maps;
  cudaError_t e = bf16_matrix_map(&maps.a, xn, rows, c, c, 64);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.b, wqkv, 3LL * c, c, c, 192);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.a2, dout, rows, c, c, 64);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.out, o, rows, c, c, 64);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.out2, dqkv, rows, 3LL * c, 3LL * c, 64);
  if (e != cudaSuccess) return e;
  maps.res = maps.a;
  maps.b2 = maps.b;
  WgGemmArgs p = {};
  p.n = c;
  p.nk = c / 64;
  p.n_tiles = c / 64;   // heads
  p.tiles = rows / 64 * p.n_tiles;
  return wg_launch<WG_TATTN_BWD, WG_MATRIX>(maps, p, stream);
}

// outf (m, n) fp32 = a @ b^T (WG_F32): a (m, k) with row pitch lda, b (n, k)
// with pitch ldb, bf16 (pitches multiples of 8 elements, pointers 16-byte
// aligned), outf with row pitch ldo (n even).
static inline cudaError_t launch_wgmma_gemm_f32(const bf16* a, long long lda, const bf16* b,
                                                long long ldb, float* outf, long long ldo,
                                                int m, int n, int k, cudaStream_t stream) {
  using mudg_host::bf16_matrix_map;
  if (n % 2) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t e = bf16_matrix_map(&ta, a, m, k, lda, WG_BM);
  if (e == cudaSuccess) e = bf16_matrix_map(&tb, b, n, k, ldb, 128);
  if (e != cudaSuccess) return e;
  WgGemmArgs p = {};
  p.n = n;
  p.m = m;
  p.nk = (k + 63) / 64;
  p.n_tiles = (n + 127) / 128;
  p.tiles = ((m + WG_BM - 1) / WG_BM) * p.n_tiles;
  p.outf = outf;
  p.ldo = ldo;
  return wg_launch<WG_F32, WG_MATRIX>(ta, tb, ta, ta, p, stream);
}

// Kernel 10's GEGLU backward tile (WG_GEGLU_BWD): u | g = x W1^T + b1 and
// dh = dy W2 (through W2^T's rows), then h = u gelu(g) and [du | dg] in
// bf16 and per 64-row tile the fp32 column sums of du and dg. x, dy: (rows,
// c) bf16; w1 (2 inner, c) bf16 [value | gate], b1 (2 inner) fp32, w2t
// (inner, c) bf16; h (rows, inner), dudg (rows, 2 inner) bf16; part
// (ceil(rows / 64), 2 inner) fp32. c % 8 == 0, inner % 64 == 0.
static inline cudaError_t launch_wgmma_geglu_bwd(const bf16* x, const bf16* dy, const bf16* w1,
                                                 const float* b1, const bf16* w2t, bf16* h,
                                                 bf16* dudg, float* part, int rows, int c,
                                                 int inner, cudaStream_t stream) {
  using mudg_host::bf16_matrix_map;
  if (c % 8 || inner % 64) return cudaErrorInvalidValue;
  WgMaps maps;
  cudaError_t e = bf16_matrix_map(&maps.a, x, rows, c, c, 64);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.a2, dy, rows, c, c, 64);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.b, w1, 2LL * inner, c, c, 64);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.b2, w2t, inner, c, c, 64);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.out, h, rows, inner, inner, 64);
  if (e == cudaSuccess) e = bf16_matrix_map(&maps.out2, dudg, rows, 2LL * inner, 2LL * inner, 64);
  if (e != cudaSuccess) return e;
  maps.res = maps.a;
  WgGemmArgs p = {};
  p.bias = b1;
  p.n = inner;
  p.gate = inner;
  p.nk = (c + 63) / 64;
  p.n_tiles = inner / 64;
  p.tiles = (rows + 63) / 64 * p.n_tiles;
  p.part = part;
  return wg_launch<WG_GEGLU_BWD, WG_MATRIX>(maps, p, stream);
}

}  // namespace mudg
