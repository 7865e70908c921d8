// Kernel 11: GroupNorm over a channels-last (N, rows, C) tensor and LayerNorm
// over the last axis of (rows, C), bf16 or fp32 in and out, fp32 statistics
// with the centered variance:
//   GN: y[n, r, c] = (x - mean[n, g(c)]) * rsqrt(var[n, g(c)] + eps) * w[c] + b[c]
//       over the rows x (C / G) elements of each (sample, group);
//   LN: y[r, c]    = (x - mean[r]) * rsqrt(var[r] + eps) * w[c] + b[c].
//
// Replaces: mudg_tpu/kernels/norms.py:_gn_kernel (fused_group_norm,
// pallas_call at :87) and _ln_kernel (fused_layer_norm, :172).
//
// Bound on this card: bytes. A GN or LN reads x once and writes y once at
// about one operation per byte, far below the 295 bf16 operations per byte
// where the tensor cores would bind; e.g. an MDM512 ds1 ResBlock GN
// (32 x 2560 x 320 bf16) moves 105 MB, 31 us at 3.35 TB/s.
//
// Design. The TPU kernel keeps one whole sample in VMEM (up to 1.5M bf16
// elements) and has one grid step per sample; an SM holds 227 KB, and N
// blocks would leave most of 132 SMs idle. So the GroupNorm cuts each sample
// into chunks of rows across blocks, in two launches:
//   1. gn_stats, one block per (chunk, sample): each thread owns 8 adjacent
//      channels and walks every k-th row of the chunk with a Welford update
//      (one read of x); the block merges its k row slots per channel, then
//      the C / G channels per group (Chan's formula, in a fixed order), and
//      writes one (mean, M2) partial per (sample, chunk, group);
//   2. gn_apply, one block per (chunk, sample): merges the sample's partials
//      per group in chunk order (Chan's formula again), then normalises its
//      rows (a second read of x, one write of y).
// No atomics: every sum is taken in an order fixed by the shape, so reruns
// are bit for bit. The Welford / Chan merges keep the centered form; the
// Pallas kernel's E[x^2] - E[x]^2 (norms.py:62-68) cancels under a DC
// offset. Both passes also work on x - K, with K the sample's first element
// of the group (row 0, which every block can read): a mean near 1e3 held in
// fp32 is off by up to half an ulp (3e-5), a mean of x - K is not, and
// (x - K) - mean' keeps the output's error at fp32 rounding of O(std).
// The LayerNorm is one warp per row with the row in registers, two passes
// over the registers (mean, then the centered variance), as _ln_kernel
// (:148-155). Loads and stores are 16-byte (8 bf16) or 2 x 16-byte (8 fp32)
// vectors, so C % 8 == 0.
#include "common.cuh"

namespace mudg {

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = unpack_bf16x2(w[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = pack_bf16x2(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// (n, mean, m2) += (nb, mean_b, m2_b): Chan et al.'s pairwise merge of two
// partial counts, means and sums of squared deviations.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                           float mean_b, float m2_b) {
  if (nb == 0.f) return;
  const float nt = n + nb;
  const float d = mean_b - mean;
  const float f = nb / nt;
  mean += d * f;
  m2 += m2_b + d * d * n * f;
  n = nt;
}

// Block layout of both GN passes: tpr = C / 8 threads per row, k = blockDim.x
// / tpr rows per step; thread (slot, cv) owns channels 8 cv .. 8 cv + 7 and
// walks rows r, r + k, ..; it loads GN_UNROLL of them before using any, so
// that a few blocks (kernel 4 has two samples: 128 blocks) still keep
// enough loads in flight. The order of the updates is the walk's.
constexpr int GN_UNROLL = 4;

// One Welford step of this thread's 8 channels by v (x - shift).
__device__ __forceinline__ void welford8(float& cnt, float (&mean)[8], float (&m2)[8],
                                         const float (&v)[8], const float (&shift)[8]) {
  cnt += 1.f;
  const float inv = 1.f / cnt;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = v[j] - shift[j];
    const float d = y - mean[j];
    mean[j] += d * inv;
    m2[j] += d * (y - mean[j]);
  }
}

template <typename T>
__global__ void gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ part,
                                int rows, int c, int groups, int per, int chunks) {
  extern __shared__ float sm[];
  const int tpr = c >> 3, k = blockDim.x / tpr;
  const int slot = threadIdx.x / tpr, c0 = (threadIdx.x % tpr) * 8;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * per, r1 = min(rows, r0 + per);
  const T* xs = x + (size_t)n * rows * c;
  const int cg = c / groups;
  float cnt = 0.f, mean[8], m2[8], shift[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mean[j] = m2[j] = 0.f;
    shift[j] = to_float(xs[(c0 + j) / cg * cg]);
  }
  int r = r0 + slot;
  for (; r + (GN_UNROLL - 1) * k < r1; r += GN_UNROLL * k) {
    float v[GN_UNROLL][8];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) load8(xs + (size_t)(r + u * k) * c + c0, v[u]);
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) welford8(cnt, mean, m2, v[u], shift);
  }
  for (; r < r1; r += k) {
    float v[8];
    load8(xs + (size_t)r * c + c0, v);
    welford8(cnt, mean, m2, v, shift);
  }
  float* smean = sm;
  float* sm2 = sm + k * c;
  float* scnt = sm + 2 * k * c;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    smean[slot * c + c0 + j] = mean[j];
    sm2[slot * c + c0 + j] = m2[j];
  }
  if (c0 == 0) scnt[slot] = cnt;
  __syncthreads();
  // per channel, the k row slots in order
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float nn = scnt[0], mu = smean[ch], q = sm2[ch];
    for (int s = 1; s < k; ++s)
      chan_merge(nn, mu, q, scnt[s], smean[s * c + ch], sm2[s * c + ch]);
    smean[ch] = mu;
    sm2[ch] = q;
  }
  __syncthreads();
  // per group, its channels in order (each counts r1 - r0 rows)
  const float nch = (float)(r1 - r0);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float nn = nch, mu = smean[g * cg], q = sm2[g * cg];
    for (int i = 1; i < cg; ++i)
      chan_merge(nn, mu, q, nch, smean[g * cg + i], sm2[g * cg + i]);
    part[((size_t)n * chunks + chunk) * groups + g] = make_float2(mu, q);
  }
}

// SILU: y = silu(GN(x)), the GroupNorm output passed through SiLU in fp32
// before its one rounding to T (kernel 4's first two steps).
template <typename T, bool SILU>
__global__ void gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                const float* __restrict__ w, const float* __restrict__ b,
                                const float2* __restrict__ part, int rows, int c, int groups,
                                int per, int chunks, float eps) {
  extern __shared__ float sm[];
  float* gmean = sm;
  float* grstd = sm + groups;
  float* gshift = sm + 2 * groups;
  const int n = blockIdx.y, chunk = blockIdx.x, cg = c / groups;
  const T* xs = x + (size_t)n * rows * c;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const float2* pp = part + (size_t)n * chunks * groups + g;
    float nn = (float)min(per, rows) * cg, mu = pp[0].x, q = pp[0].y;
    for (int j = 1; j < chunks; ++j) {
      const float2 pj = pp[(size_t)j * groups];
      chan_merge(nn, mu, q, (float)min(per, rows - j * per) * cg, pj.x, pj.y);
    }
    gmean[g] = mu;
    grstd[g] = rsqrtf(q / nn + eps);
    gshift[g] = to_float(xs[g * cg]);
  }
  __syncthreads();
  const int tpr = c >> 3, k = blockDim.x / tpr;
  const int slot = threadIdx.x / tpr, c0 = (threadIdx.x % tpr) * 8;
  float mu[8], rs[8], ww[8], bb[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int g = (c0 + j) / cg;
    sh[j] = gshift[g];
    mu[j] = gmean[g];
    rs[j] = grstd[g];
    ww[j] = w[c0 + j];
    bb[j] = b[c0 + j];
  }
  const int r0 = chunk * per, r1 = min(rows, r0 + per);
  const size_t base = (size_t)n * rows * c + c0;
  auto apply = [&](float (&v)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = ((v[j] - sh[j]) - mu[j]) * rs[j] * ww[j] + bb[j];
      if (SILU) v[j] = v[j] / (1.f + expf(-v[j]));
    }
  };
  int r = r0 + slot;
  for (; r + (GN_UNROLL - 1) * k < r1; r += GN_UNROLL * k) {
    float v[GN_UNROLL][8];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) load8(x + base + (size_t)(r + u * k) * c, v[u]);
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      apply(v[u]);
      store8(y + base + (size_t)(r + u * k) * c, v[u]);
    }
  }
  for (; r < r1; r += k) {
    float v[8];
    load8(x + base + (size_t)r * c, v);
    apply(v);
    store8(y + base + (size_t)r * c, v);
  }
}

// One warp per row; lane l holds the 16-byte vectors l, l + 32, .. of it.
// The row's mean and rstd go to mean[row] and rstd[row] where mean is not
// null (kernel 9's LN backward reads them).
template <typename T, int VPL>
__global__ void __launch_bounds__(256) ln_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                 const float* __restrict__ w,
                                                 const float* __restrict__ b, int rows,
                                                 int c, float eps, float* __restrict__ mean_out,
                                                 float* __restrict__ rstd_out) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nv = c >> 3;
  const T* xr = x + (size_t)row * c;
  float v[VPL][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nv) {
      load8(xr + vi * 8, v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[i][j];
    }
  }
  const float mean = warp_sum(s) / c;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / c + eps);
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  T* yr = y + (size_t)row * c;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nv) {
      float ww[8], bb[8];
      load8(w + vi * 8, ww);
      load8(b + vi * 8, bb);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = (v[i][j] - mean) * rstd * ww[j] + bb[j];
      store8(yr + vi * 8, v[i]);
    }
  }
}

template <typename T, bool SILU = false>
cudaError_t launch_gn(const T* x, T* y, const float* w, const float* b, float2* part, int n,
                      int rows, int c, int groups, int per, int chunks, float eps,
                      cudaStream_t stream) {
  const int tpr = c / 8, k = tpr >= 256 ? 1 : 256 / tpr;
  const dim3 grid(chunks, n);
  gn_stats_kernel<T><<<grid, tpr * k, (2 * k * c + k) * sizeof(float), stream>>>(
      x, part, rows, c, groups, per, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T, SILU><<<grid, tpr * k, 3 * groups * sizeof(float), stream>>>(
      x, y, w, b, part, rows, c, groups, per, chunks, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln(const T* x, T* y, const float* w, const float* b, int rows, int c,
                      float eps, cudaStream_t stream, float* mean = nullptr,
                      float* rstd = nullptr) {
  const int vpl = (c / 8 + 31) / 32;
  const dim3 grid((rows + 7) / 8);
  if (vpl <= 1) ln_kernel<T, 1><<<grid, 256, 0, stream>>>(x, y, w, b, rows, c, eps, mean, rstd);
  else if (vpl <= 2) ln_kernel<T, 2><<<grid, 256, 0, stream>>>(x, y, w, b, rows, c, eps, mean, rstd);
  else if (vpl <= 4) ln_kernel<T, 4><<<grid, 256, 0, stream>>>(x, y, w, b, rows, c, eps, mean, rstd);
  else if (vpl <= 8) ln_kernel<T, 8><<<grid, 256, 0, stream>>>(x, y, w, b, rows, c, eps, mean, rstd);
  else ln_kernel<T, 16><<<grid, 256, 0, stream>>>(x, y, w, b, rows, c, eps, mean, rstd);
  return cudaGetLastError();
}

}  // namespace mudg

using namespace mudg;

// x, y: (n, rows, c) contiguous, bf16 (fp32 = 0) or fp32 (fp32 = 1); w, b:
// (c) fp32; part: n * chunks * groups (mean, M2) fp32 pairs of scratch.
// c % 8 == 0, c <= 4096, groups | c; the rows of a sample are cut into
// `chunks` chunks of `per` rows (the last one may be shorter, none empty).
extern "C" int mudg_group_norm(const void* x, void* y, const void* w, const void* b,
                               void* part, int n, int rows, int c, int groups, int per,
                               int chunks, int fp32, float eps, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float2* pp = static_cast<float2*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return launch_gn(static_cast<const float*>(x), static_cast<float*>(y), wf, bf, pp, n,
                     rows, c, groups, per, chunks, eps, s);
  return launch_gn(static_cast<const bf16*>(x), static_cast<bf16*>(y), wf, bf, pp, n, rows,
                   c, groups, per, chunks, eps, s);
}

// y = silu(GroupNorm(x)) in fp32, rounded to bf16 once; x, y: (n, rows, c)
// bf16, the rest as mudg_group_norm (kernel 4's statistics and h).
extern "C" int mudg_group_norm_silu(const void* x, void* y, const void* w, const void* b,
                                    void* part, int n, int rows, int c, int groups, int per,
                                    int chunks, float eps, void* stream) {
  return launch_gn<bf16, true>(static_cast<const bf16*>(x), static_cast<bf16*>(y),
                               static_cast<const float*>(w), static_cast<const float*>(b),
                               static_cast<float2*>(part), n, rows, c, groups, per, chunks, eps,
                               static_cast<cudaStream_t>(stream));
}

// x, y: (rows, c) contiguous, bf16 or fp32 as above; w, b: (c) fp32.
// c % 8 == 0, c <= 4096.
extern "C" int mudg_layer_norm(const void* x, void* y, const void* w, const void* b,
                               int rows, int c, int fp32, float eps, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return launch_ln(static_cast<const float*>(x), static_cast<float*>(y), wf, bf, rows, c,
                     eps, s);
  return launch_ln(static_cast<const bf16*>(x), static_cast<bf16*>(y), wf, bf, rows, c, eps,
                   s);
}

// mudg_layer_norm in bf16 that also writes each row's fp32 mean and rstd
// (rows) (kernel 9: xn and the statistics of its LN backward).
extern "C" int mudg_layer_norm_stats(const void* x, void* y, const void* w, const void* b,
                                     void* mean, void* rstd, int rows, int c, float eps,
                                     void* stream) {
  return launch_ln(static_cast<const bf16*>(x), static_cast<bf16*>(y),
                   static_cast<const float*>(w), static_cast<const float*>(b), rows, c, eps,
                   static_cast<cudaStream_t>(stream), static_cast<float*>(mean),
                   static_cast<float*>(rstd));
}
