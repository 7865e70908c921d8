// Reductions over rows for kernel 9 (the temporal attention's backward):
// the weight-gradient GEMM on mma.sync and the per-row LayerNorm backward
// (the column sums are in reduce.cuh; kernel 10's weight gradients run on
// wgmma_wgrad.cuh).
//
// A weight gradient is a sum over every row of the batch:
//   out(M, N) = sum_k A[k, m] * B[k, n],   A (K, M), B (K, N) row-major,
// with K the rows (tokens) and M, N channel widths. The TPU kernels add each
// row block into one revisited fp32 output block of a sequential grid; the
// CTAs of a CUDA grid run at once, so here the rows are the K dimension of a
// GEMM. When the (M, N) tiles alone would leave the card idle, K is cut into
// at most 64 contiguous splits, each split writes its own fp32 partial
// (splits, M, N), and a second pass adds the partials in split order. No
// atomics: the result is the same bit for bit from run to run.
//
// The tile loop is the one of gemm.cuh (128x128x32, 8 warps, mma.sync m16n8k16
// bf16 -> fp32, two register-staged shared stages); the operands arrive with
// K as their outer dimension, so each 16-byte load (8 values of M or N at one
// k) is transposed on its way into shared memory. B_LN applies the LayerNorm
// of x to B from per-row fp32 statistics and the fp32 affine, rounded to bf16
// as the forward rounds it, so the normalised x never goes to device memory.
#pragma once

#include <algorithm>

#include "gemm.cuh"
#include "reduce.cuh"

namespace mudg {

enum { B_PLAIN = 0, B_LN = 1 };

struct WgradArgs {
  const bf16* a;   // (K, M), row stride lda
  int lda;
  const bf16* b;   // (K, N), row stride ldb
  int ldb;
  float* out;      // (M, N) fp32, or the (splits, M, N) partials
  int m, n, k;
  int kchunk;      // rows per split, a multiple of 32
  const float* row_mean;   // B_LN
  const float* row_rstd;
  const float* ln_w;
  const float* ln_b;
};

// 8 values at (row, col..col+7) of a (K, width) operand, zero past `width`.
template <int MODE>
__device__ __forceinline__ uint4 wgrad_load(const WgradArgs& p, const bf16* src, int ld,
                                            int width, int row, int col) {
  if (col >= width) return make_uint4(0u, 0u, 0u, 0u);
  uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)row * ld + col);
  if (MODE == B_LN) {
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
    raw = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return raw;
}

__device__ __forceinline__ void store_transposed(bf16* tile, uint4 v, int kr, int col) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) tile[(col + j) * GLDS + kr] = e[j];
}

template <int BMODE>
__global__ void __launch_bounds__(GEMM_THREADS) wgrad_kernel(const WgradArgs p) {
  __shared__ __align__(16) bf16 As[2][GBM * GLDS];
  __shared__ __align__(16) bf16 Bs[2][GBN * GLDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  const int k0 = blockIdx.z * p.kchunk;
  const int k1 = min(p.k, k0 + p.kchunk);
  const int ktiles = (k1 - k0) / GBK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // each thread moves two 16-byte chunks of each 32 x 128 operand tile:
  // chunk c is k row c / 16, columns (c % 16) * 8 ..
  uint4 ra[2], rb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * GEMM_THREADS, kr = c >> 4, col = (c & 15) * 8;
    ra[i] = wgrad_load<B_PLAIN>(p, p.a, p.lda, p.m, k0 + kr, m0 + col);
    rb[i] = wgrad_load<BMODE>(p, p.b, p.ldb, p.n, k0 + kr, n0 + col);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * GEMM_THREADS, kr = c >> 4, col = (c & 15) * 8;
    store_transposed(As[0], ra[i], kr, col);
    store_transposed(Bs[0], rb[i], kr, col);
  }
  __syncthreads();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * GEMM_THREADS, kr = c >> 4, col = (c & 15) * 8;
        const int row = k0 + (kt + 1) * GBK + kr;
        ra[i] = wgrad_load<B_PLAIN>(p, p.a, p.lda, p.m, row, m0 + col);
        rb[i] = wgrad_load<BMODE>(p, p.b, p.ldb, p.n, row, n0 + col);
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
        const int r = wn * 32 + nj * 8 + g;
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
        const int c = tid + i * GEMM_THREADS, kr = c >> 4, col = (c & 15) * 8;
        store_transposed(As[cur ^ 1], ra[i], kr, col);
        store_transposed(Bs[cur ^ 1], rb[i], kr, col);
      }
    }
    __syncthreads();
  }

  float* out = p.out + (size_t)blockIdx.z * p.m * p.n;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= p.m) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + wn * 32 + nj * 8 + 2 * q;
        if (col >= p.n) continue;
        *reinterpret_cast<float2*>(out + (size_t)row * p.n + col) =
            make_float2(acc[mi][nj][half * 2], acc[mi][nj][half * 2 + 1]);
      }
    }
  }
}

// out (M, N) fp32 = A^T B over K rows (K % 32 == 0, M and N multiples of 8),
// split over K when the tiles alone are few, partials in `work` (work_elems
// fp32); the split count is fixed by the shapes and the work size alone.
template <int BMODE>
static inline cudaError_t launch_wgrad(WgradArgs p, float* out, float* work,
                                       long long work_elems, cudaStream_t st) {
  const int gn = (p.n + GBN - 1) / GBN, gm = (p.m + GBM - 1) / GBM;
  const int ktiles = p.k / GBK;
  int splits = std::max(1, std::min({264 / (gn * gm), ktiles / 4, 64}));
  while (splits > 1 && (long long)splits * p.m * p.n > work_elems) --splits;
  const int per = (ktiles + splits - 1) / splits;
  p.kchunk = per * GBK;
  splits = (ktiles + per - 1) / per;
  p.out = splits > 1 ? work : out;
  wgrad_kernel<BMODE><<<dim3(gn, gm, splits), GEMM_THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_split_sum(work, splits, (long long)p.m * p.n, out, st);
}

static inline WgradArgs wgrad_args(const void* a, int lda, const void* b, int ldb, int m,
                                   int n, int k) {
  WgradArgs p;
  memset(&p, 0, sizeof(p));
  p.a = static_cast<const bf16*>(a);
  p.lda = lda;
  p.b = static_cast<const bf16*>(b);
  p.ldb = ldb;
  p.m = m;
  p.n = n;
  p.k = k;
  return p;
}

// LayerNorm backward of one row per warp, plus the residual's gradient:
//   dx = dy + rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)),
//   dxh = dxn * ln_w, xhat = (x - mean) * rstd, all fp32, dx rounded to bf16.
static __global__ void ln_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                                     const float* __restrict__ dxn,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ rstd,
                                     const float* __restrict__ ln_w, int rows, int cols,
                                     bf16* __restrict__ dx) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * cols;
  const float mu = mean[row], rs = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float xh = (__bfloat162float(x[base + c]) - mu) * rs;
    const float dxh = dxn[base + c] * ln_w[c];
    s1 += dxh;
    s2 += dxh * xh;
  }
  s1 = warp_sum(s1) / cols;
  s2 = warp_sum(s2) / cols;
  for (int c = lane; c < cols; c += 32) {
    const float xh = (__bfloat162float(x[base + c]) - mu) * rs;
    const float dxh = dxn[base + c] * ln_w[c];
    dx[base + c] = __float2bfloat16(__bfloat162float(dy[base + c]) + rs * (dxh - s1 - xh * s2));
  }
}

static inline cudaError_t launch_ln_bwd(const bf16* x, const bf16* dy, const float* dxn,
                                        const float* mean, const float* rstd,
                                        const float* ln_w, int rows, int cols, bf16* dx,
                                        cudaStream_t st) {
  ln_bwd_kernel<<<(rows + 7) / 8, 256, 0, st>>>(x, dy, dxn, mean, rstd, ln_w, rows, cols, dx);
  return cudaGetLastError();
}

}  // namespace mudg
