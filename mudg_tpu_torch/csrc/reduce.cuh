// Fixed-order reductions shared by the backward kernels (9 and 10): the sum
// of split partials in split order, and column sums over rows in row chunks
// (each chunk's sum in row order, the chunks' partials in chunk order). No
// atomics: a rerun gives the same bits.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace mudg {

// out[i] = sum over s of part[s * count + i], s in order.
static __global__ void split_sum_kernel(const float* __restrict__ part, int splits,
                                        long long count, float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < splits; ++j) s += part[j * count + i];
    out[i] = s;
  }
}

static inline cudaError_t launch_split_sum(const float* part, int splits, long long count,
                                           float* out, cudaStream_t st) {
  const int blocks = (int)std::min<long long>((count + 255) / 256, 4096);
  split_sum_kernel<<<blocks, 256, 0, st>>>(part, splits, count, out);
  return cudaGetLastError();
}

// Column sums over rows [s*rchunk, (s+1)*rchunk) into part[s][col]:
//   C_BF16  a bf16;   C_F32  a fp32;
//   C_XHAT  a fp32 times xhat = (x - mean[row]) * rstd[row], x bf16.
enum { C_BF16 = 0, C_F32 = 1, C_XHAT = 2 };

template <int MODE>
__global__ void colsum_kernel(const void* __restrict__ a, int rows, int cols, int rchunk,
                              float* __restrict__ part, const bf16* __restrict__ x,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const int r0 = blockIdx.y * rchunk, r1 = min(rows, r0 + rchunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t i = (size_t)r * cols + col;
    float v;
    if (MODE == C_BF16) {
      v = __bfloat162float(static_cast<const bf16*>(a)[i]);
    } else {
      v = static_cast<const float*>(a)[i];
    }
    if (MODE == C_XHAT) v *= (__bfloat162float(x[i]) - mean[r]) * rstd[r];
    s += v;
  }
  part[(size_t)blockIdx.y * cols + col] = s;
}

template <int MODE>
static inline cudaError_t launch_colsum(const void* a, int rows, int cols, float* out,
                                        float* work, long long work_elems, cudaStream_t st,
                                        const bf16* x = nullptr, const float* mean = nullptr,
                                        const float* rstd = nullptr) {
  int splits = std::max(1, std::min(64, rows / 256));
  while (splits > 1 && (long long)splits * cols > work_elems) --splits;
  const int rchunk = (rows + splits - 1) / splits;
  splits = (rows + rchunk - 1) / rchunk;
  float* part = splits > 1 ? work : out;
  colsum_kernel<MODE><<<dim3((cols + 127) / 128, splits), 128, 0, st>>>(
      a, rows, cols, rchunk, part, x, mean, rstd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_split_sum(work, splits, cols, out, st);
}

}  // namespace mudg
