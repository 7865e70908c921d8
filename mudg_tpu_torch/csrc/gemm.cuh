// One bf16 tile GEMM with fp32 accumulation on mma.sync, shared by kernel
// 2 and the backward kernels 9 and 10:
//   out(M, N) = prologue(A)(M, K) @ B(N, K)^T -> epilogue.
//
// B is stored (N, K) with K contiguous: the torch layout of a Linear weight
// (out, in), so a weight is used as it is loaded.
//
// Prologues (what A is):
//   A_PLAIN  A itself, bf16 (M, K).
//   A_LN     LayerNorm of A from per-row fp32 mean/rstd and the fp32 affine,
//            rounded to bf16 as the reference rounds the LN output.
// Epilogues (what is stored, bf16):
//   E_BIAS      acc + bias (bias may be null)
//   E_BIAS_RES  acc + bias + res
//   E_F32       acc + bias (bias may be null), stored fp32 to outf.
//   E_GEGLU_BWD the GEGLU backward from the recomputed u = acc over W rows
//               [n0, n0+64) + b[j] and g = acc over W rows [inner+n0, ...) +
//               b[inner+j] (each warp holds the value and gate columns of
//               the same j) and the fp32 upstream gradient dh (M, inner):
//               h = u*gelu(g) to out, du = dh*gelu(g) and
//               dg = dh*u*(Phi(g) + g*pdf(g)) to out2 as [du | dg] (bf16),
//               and per 64-row warp slab the fp32 column sums of du and dg
//               to part (one row of 2*inner per slab, no atomics).
//
// Tiles: 128x128x32, 8 warps (2 along M x 4 along N, 64x32 each), two shared
// memory stages filled from registers (the prologue transforms each 16-byte
// chunk on its way in), padded rows (40 bf16) so fragment loads are free of
// bank conflicts. K must be a multiple of 32; N need not be a multiple of
// 128 (edge columns are masked); M need not be a multiple of 128.
#pragma once

#include <string.h>

#include "common.cuh"

namespace mudg {

enum { A_PLAIN = 0, A_LN = 1 };
enum { E_BIAS = 0, E_BIAS_RES = 1, E_F32 = 3, E_GEGLU_BWD = 4 };

__host__ __device__ constexpr bool geglu_cols(int em) { return em == E_GEGLU_BWD; }

struct GemmArgs {
  const bf16* a;
  int lda;
  const bf16* b;
  int ldb;
  bf16* out;
  int ldo;
  int m, n, k;
  const float* bias;
  const bf16* res;
  int ldr;
  // A_LN
  const float* row_mean;
  const float* row_rstd;
  const float* ln_w;
  const float* ln_b;
  // E_GEGLU_BWD
  int inner;
  // E_F32
  float* outf;
  // E_GEGLU_BWD
  const float* dh;
  bf16* out2;
  float* part;
};

constexpr int GBM = 128, GBN = 128, GBK = 32, GLDS = GBK + 8;
constexpr int GEMM_THREADS = 256;

template <int AM>
__device__ __forceinline__ uint4 gemm_load_a(const GemmArgs& p, int row,
                                             int col) {
  uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (row >= p.m) return zero;
  if (AM == A_PLAIN) {
    return *reinterpret_cast<const uint4*>(p.a + (size_t)row * p.lda + col);
  } else {
    uint4 raw =
        *reinterpret_cast<const uint4*>(p.a + (size_t)row * p.lda + col);
    const float mu = p.row_mean[row], rs = p.row_rstd[row];
    uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = unpack_bf16x2(w[i]);
      const int c = col + 2 * i;
      f.x = (f.x - mu) * rs * p.ln_w[c] + p.ln_b[c];
      f.y = (f.y - mu) * rs * p.ln_w[c + 1] + p.ln_b[c + 1];
      w[i] = pack_bf16x2(f.x, f.y);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Row `r` of the B tile: for E_GEGLU_BWD rows 0..63 are value rows n0.. and
// rows 64..127 the matching gate rows inner+n0..
template <int EM>
__device__ __forceinline__ uint4 gemm_load_b(const GemmArgs& p, int n0, int r,
                                             int col) {
  int n;
  if (geglu_cols(EM)) {
    n = r < 64 ? n0 + r : p.inner + n0 + (r - 64);
  } else {
    n = n0 + r;
    if (n >= p.n) return make_uint4(0u, 0u, 0u, 0u);
  }
  return *reinterpret_cast<const uint4*>(p.b + (size_t)n * p.ldb + col);
}

// First tile column of n-fragment `nj` (8 columns) of warp column `wn`.
template <int EM>
__device__ __forceinline__ int gemm_col(int wn, int nj) {
  if (geglu_cols(EM)) return nj < 2 ? wn * 16 + nj * 8 : 64 + wn * 16 + (nj - 2) * 8;
  return wn * 32 + nj * 8;
}

template <int AM, int EM>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const GemmArgs p) {
  __shared__ __align__(16) bf16 As[2][GBM * GLDS];
  __shared__ __align__(16) bf16 Bs[2][GBN * GLDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  // blockIdx.x walks N so that neighbouring blocks share their A rows in L2
  const int n0 = geglu_cols(EM) ? blockIdx.x * 64 : blockIdx.x * GBN;
  const int m0 = blockIdx.y * GBM;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint4 ra[2], rb[2];
  const int ktiles = p.k / GBK;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * GEMM_THREADS, r = c >> 2, col = (c & 3) * 8;
    ra[i] = gemm_load_a<AM>(p, m0 + r, col);
    rb[i] = gemm_load_b<EM>(p, n0, r, col);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * GEMM_THREADS, r = c >> 2, col = (c & 3) * 8;
    *reinterpret_cast<uint4*>(&As[0][r * GLDS + col]) = ra[i];
    *reinterpret_cast<uint4*>(&Bs[0][r * GLDS + col]) = rb[i];
  }
  __syncthreads();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * GEMM_THREADS, r = c >> 2, col = (c & 3) * 8;
        ra[i] = gemm_load_a<AM>(p, m0 + r, (kt + 1) * GBK + col);
        rb[i] = gemm_load_b<EM>(p, n0, r, (kt + 1) * GBK + col);
      }
    }
    const bf16* as = As[cur];
    const bf16* bs = Bs[cur];
#pragma unroll
    for (int ks = 0; ks < GBK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = lds32(as + r * GLDS + ks + 2 * q);
        af[mi][1] = lds32(as + (r + 8) * GLDS + ks + 2 * q);
        af[mi][2] = lds32(as + r * GLDS + ks + 2 * q + 8);
        af[mi][3] = lds32(as + (r + 8) * GLDS + ks + 2 * q + 8);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int r = gemm_col<EM>(wn, nj) + g;
        bfr[nj][0] = lds32(bs + r * GLDS + ks + 2 * q);
        bfr[nj][1] = lds32(bs + r * GLDS + ks + 2 * q + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_16816(acc[mi][nj], af[mi], bfr[nj]);
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * GEMM_THREADS, r = c >> 2, col = (c & 3) * 8;
        *reinterpret_cast<uint4*>(&As[cur ^ 1][r * GLDS + col]) = ra[i];
        *reinterpret_cast<uint4*>(&Bs[cur ^ 1][r * GLDS + col]) = rb[i];
      }
    }
    __syncthreads();
  }

  if (EM == E_GEGLU_BWD) {
    // column sums of du, dg over this warp's 64 rows: [nj][e]
    float su[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, sg[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    const int ld2 = 2 * p.inner;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row >= p.m) continue;
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int col = n0 + wn * 16 + nj * 8 + 2 * q;
          const float2 dh = *reinterpret_cast<const float2*>(p.dh + (size_t)row * p.inner + col);
          const float dhv[2] = {dh.x, dh.y};
          float h[2], du[2], dg[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float u = acc[mi][nj][half * 2 + e] + p.bias[col + e];
            const float gt = acc[mi][nj + 2][half * 2 + e] + p.bias[p.inner + col + e];
            const float phi = 0.5f * (1.f + erff(gt * 0.70710678118654752f));
            const float pdf = expf(-0.5f * gt * gt) * 0.3989422804014327f;
            h[e] = u * gt * phi;
            du[e] = dhv[e] * gt * phi;
            dg[e] = dhv[e] * u * (phi + gt * pdf);
            su[nj][e] += du[e];
            sg[nj][e] += dg[e];
          }
          *reinterpret_cast<uint32_t*>(p.out + (size_t)row * p.ldo + col) = pack_bf16x2(h[0], h[1]);
          bf16* o2 = p.out2 + (size_t)row * ld2 + col;
          *reinterpret_cast<uint32_t*>(o2) = pack_bf16x2(du[0], du[1]);
          *reinterpret_cast<uint32_t*>(o2 + p.inner) = pack_bf16x2(dg[0], dg[1]);
        }
      }
    }
    // lanes of one q hold the same columns: sum over g (lane bits 2..4)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          su[nj][e] += __shfl_xor_sync(0xffffffffu, su[nj][e], off);
          sg[nj][e] += __shfl_xor_sync(0xffffffffu, sg[nj][e], off);
        }
    if (g == 0) {
      float* prow = p.part + (size_t)(blockIdx.y * 2 + wm) * ld2;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 16 + nj * 8 + 2 * q + e;
          prow[col] = su[nj][e];
          prow[p.inner + col] = sg[nj][e];
        }
    }
    return;
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= p.m) continue;
      bf16* orow = p.out + (size_t)row * p.ldo;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + gemm_col<EM>(wn, nj) + 2 * q;
        if (col >= p.n) continue;
        float v0 = acc[mi][nj][half * 2], v1 = acc[mi][nj][half * 2 + 1];
        if (p.bias != nullptr) {
          v0 += p.bias[col];
          v1 += p.bias[col + 1];
        }
        if (EM == E_BIAS_RES) {
          const float2 r = unpack_bf16x2(lds32(p.res + (size_t)row * p.ldr + col));
          v0 += r.x;
          v1 += r.y;
        }
        if (EM == E_F32) {
          *reinterpret_cast<float2*>(p.outf + (size_t)row * p.ldo + col) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16x2(v0, v1);
        }
      }
    }
  }
}

template <int AM, int EM>
static inline cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  const int gn = geglu_cols(EM) ? p.inner / 64 : (p.n + GBN - 1) / GBN;
  const dim3 grid(gn, (p.m + GBM - 1) / GBM);
  gemm_kernel<AM, EM><<<grid, GEMM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

static inline GemmArgs gemm_args() {
  GemmArgs p;
  memset(&p, 0, sizeof(p));
  return p;
}

}  // namespace mudg
