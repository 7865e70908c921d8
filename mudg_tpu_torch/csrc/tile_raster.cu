// Kernel 13: front-to-back alpha compositing of (tile, depth)-sorted
// gaussian/tile pairs per 16x16 tile, and its backward.
//
// Replaces: mudg_tpu/gs/tile_raster.py:_fwd_kernel (pallas_call at :535) and
// _bwd_kernel (pallas_call at :709), the custom-vjp op composite_tiles :722.
//
// Input: a row-major pair table feats (P, nfeat) f32, nfeat = 6 + npay, row
// [mux, muy, conic a, b, c, opacity, payload...] with payload = [r, g, b,
// depth, extras...], sorted by (tile, depth); bounds (n_tiles + 1) i32, tile
// t's pairs are rows bounds[t] .. bounds[t+1]. Output out (n_tiles, npay + 1,
// 256) f32: the payload sums and the final transmittance T per pixel, and
// last (n_tiles, 256) i32: per pixel, 1 + the index within its tile of the
// last pair that contributed (0 if none), which the backward starts from.
//
// Semantics (mudg_tpu/gs/rasterize.py:165-184): pixel centres at +0.5,
// alpha = min(op * exp(power), 0.999), zero below 1/255, a pair contributes
// only where the transmittance before it is above 1e-4, the payload is
// accumulated with weight alpha * T.
//
// Bound on this card: FP32 instruction throughput. Per (pair, pixel)
// evaluation the forward does ~12 operations and an exp, plus 2 * npay for a
// contributing pair,
// over only 4 * nfeat bytes per pair and 4 * (npay + 1) per pixel; the
// backward ~3x that, plus a sum over the tile's 256 pixels per pair.
//
// Forward design: one block per tile, one thread per pixel. The tile's pairs
// are staged through shared memory in batches of 256 rows (a coalesced copy
// of the contiguous rows), and each thread composites them in order with a
// plain running product T *= (1 - alpha); the TPU's log-space triangular
// matmul fed the MXU and has no purpose here. At every batch boundary the
// block exits once no pixel has T > 1e-4 (__syncthreads_count), as the TPU
// kernel's per-chunk max(T) > T_MIN test does.
//
// Backward design: a back-to-front walk from the forward's final T, as the
// public CUDA 3DGS rasterizer does. With S the sum over the later pairs of
// w * G (G = payload . dL/dpayload) plus the tail T_final * dL/dT_final,
//   T_before = T_after / (1 - alpha),
//   dL/dalpha = T_before * G - S / (1 - alpha),   S += alpha * T_before * G.
// The walk starts at the pixel's last contributing pair (from `last`), so
// the T > 1e-4 gate is never re-decided from a reconstructed T. It keeps no
// total - prefix difference: the TPU's two forward sweeps (totals, then
// prefix with suffix = total - prefix) cancel where tiles saturate, while
// here S is summed from the small end. Each pair's gradient row is a sum over
// the 256 pixels: shuffles within each warp (skipped for a pair no lane of
// the warp touches), then the 8 warps' partials from shared memory in a
// fixed order, written once per pair. No atomics: two runs agree bit for bit.
// Rows past the tile's largest `last` are not written (the wrapper zeroes
// the gradient table).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int NWARP = NPIX / 32;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.999f;
constexpr float T_MIN = 1e-4f;
constexpr int FWD_BATCH = 256;   // pair rows staged per forward batch
constexpr int BWD_BATCH = 32;    // pair rows per backward batch
constexpr int MAX_PAY = 26;

// power = -0.5 * (a dx^2 + c dy^2) - b dx dy and g2d = exp(power), rounded
// op by op in the order PyTorch's elementwise ops take (no FMA contraction),
// so that the plain version's float32 alpha, and with it every
// alpha >= 1/255 decision, is the kernel's bit for bit.
__device__ __forceinline__ float gauss2d(const float* f, float dx, float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(f[2], dx), dx), __fmul_rn(__fmul_rn(f[4], dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(f[3], dx), dy));
  return expf(power);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int MAXP>
__global__ void __launch_bounds__(NPIX)
composite_fwd(const float* __restrict__ feats, const int* __restrict__ bounds, int tw,
              int npay, float* __restrict__ out, int* __restrict__ last) {
  extern __shared__ float rows[];   // FWD_BATCH x nfeat
  const int nfeat = 6 + npay;
  const int t = blockIdx.x, tid = threadIdx.x;
  const int start = bounds[t], end = bounds[t + 1];
  const float px = (float)((t % tw) * TILE + tid % TILE) + 0.5f;
  const float py = (float)((t / tw) * TILE + tid / TILE) + 0.5f;
  float T = 1.f;
  float acc[MAXP];
#pragma unroll
  for (int c = 0; c < MAXP; ++c) acc[c] = 0.f;
  int lastc = 0;

  for (int b0 = start; b0 < end; b0 += FWD_BATCH) {
    // a barrier (the previous batch is consumed) and the tile's early exit
    if (__syncthreads_count(T > T_MIN) == 0) break;
    const int n = min(FWD_BATCH, end - b0);
    const float* src = feats + (size_t)b0 * nfeat;
    for (int i = tid; i < n * nfeat; i += NPIX) rows[i] = src[i];
    __syncthreads();
    if (T > T_MIN) {
      for (int j = 0; j < n; ++j) {
        const float* f = rows + j * nfeat;
        const float dx = __fsub_rn(px, f[0]), dy = __fsub_rn(py, f[1]);
        const float alpha = fminf(__fmul_rn(f[5], gauss2d(f, dx, dy)), ALPHA_MAX);
        if (!(alpha >= ALPHA_MIN)) continue;
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < MAXP; ++c)
          if (c < npay) acc[c] += w * f[6 + c];
        T *= 1.f - alpha;
        lastc = b0 - start + j + 1;
        if (T <= T_MIN) break;
      }
    }
  }
  float* o = out + (size_t)t * (npay + 1) * NPIX;
#pragma unroll
  for (int c = 0; c < MAXP; ++c)
    if (c < npay) o[c * NPIX + tid] = acc[c];
  o[npay * NPIX + tid] = T;
  last[(size_t)t * NPIX + tid] = lastc;
}

template <int MAXP>
__global__ void __launch_bounds__(NPIX)
composite_bwd(const float* __restrict__ feats, const int* __restrict__ bounds, int tw, int npay,
              const float* __restrict__ out, const int* __restrict__ last,
              const float* __restrict__ gout, float* __restrict__ dfeats) {
  extern __shared__ float smem[];
  const int nfeat = 6 + npay;
  float* rows = smem;                          // BWD_BATCH x nfeat
  float* part = smem + BWD_BATCH * nfeat;      // NWARP x BWD_BATCH x nfeat
  __shared__ int wmax[NWARP];
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = bounds[t];
  const float px = (float)((t % tw) * TILE + tid % TILE) + 0.5f;
  const float py = (float)((t / tw) * TILE + tid / TILE) + 0.5f;
  const float* o = out + (size_t)t * (npay + 1) * NPIX;
  const float* go = gout + (size_t)t * (npay + 1) * NPIX;
  float gp[MAXP];
#pragma unroll
  for (int c = 0; c < MAXP; ++c) gp[c] = c < npay ? go[c * NPIX + tid] : 0.f;
  float Tcur = o[npay * NPIX + tid];           // T after the current pair
  float S = Tcur * go[npay * NPIX + tid];      // later pairs' w * G, plus the tail
  const int lastc = last[(size_t)t * NPIX + tid];
  const int m = __reduce_max_sync(0xffffffffu, lastc);
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  int maxlast = wmax[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) maxlast = max(maxlast, wmax[w]);

  for (int hi = maxlast; hi > 0; hi -= BWD_BATCH) {
    const int lo = max(0, hi - BWD_BATCH), n = hi - lo;
    __syncthreads();   // the previous batch's rows and partials are consumed
    const float* src = feats + (size_t)(start + lo) * nfeat;
    for (int i = tid; i < n * nfeat; i += NPIX) rows[i] = src[i];
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      const float* f = rows + j * nfeat;
      float g[6 + MAXP];
#pragma unroll
      for (int k = 0; k < 6 + MAXP; ++k) g[k] = 0.f;
      bool hit = false;
      if (lo + j < lastc) {
        const float dx = __fsub_rn(px, f[0]), dy = __fsub_rn(py, f[1]);
        const float g2d = gauss2d(f, dx, dy);
        const float a0 = __fmul_rn(f[5], g2d);
        const float alpha = fminf(a0, ALPHA_MAX);
        if (alpha >= ALPHA_MIN) {
          hit = true;
          const float one_m = 1.f - alpha;
          const float Tb = Tcur / one_m;
          float G = 0.f;
#pragma unroll
          for (int c = 0; c < MAXP; ++c)
            if (c < npay) G += gp[c] * f[6 + c];
          const float dalpha = Tb * G - S / one_m;
          const float w = alpha * Tb;
          S += w * G;
          Tcur = Tb;
          if (a0 < ALPHA_MAX) {   // no gradient through the 0.999 clamp
            const float dpow = dalpha * a0;
            g[0] = dpow * (f[2] * dx + f[3] * dy);
            g[1] = dpow * (f[4] * dy + f[3] * dx);
            g[2] = -0.5f * dpow * dx * dx;
            g[3] = -dpow * dx * dy;
            g[4] = -0.5f * dpow * dy * dy;
            g[5] = dalpha * g2d;
          }
#pragma unroll
          for (int c = 0; c < MAXP; ++c) g[6 + c] = w * gp[c];
        }
      }
      float* pj = part + (warp * BWD_BATCH + j) * nfeat;
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int k = 0; k < 6 + MAXP; ++k) {
          if (k < nfeat) {
            const float v = warp_sum(g[k]);
            if (lane == 0) pj[k] = v;
          }
        }
      } else if (lane < nfeat) {
        pj[lane] = 0.f;
      }
    }
    __syncthreads();
    float* dst = dfeats + (size_t)(start + lo) * nfeat;
    for (int i = tid; i < n * nfeat; i += NPIX) {
      const int j = i / nfeat, k = i - j * nfeat;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) s += part[(w * BWD_BATCH + j) * nfeat + k];
      dst[i] = s;
    }
  }
}

template <int MAXP>
cudaError_t launch_fwd(const float* feats, const int* bounds, float* out, int* last,
                       int n_tiles, int tw, int npay, cudaStream_t stream) {
  const size_t smem = sizeof(float) * FWD_BATCH * (6 + npay);
  composite_fwd<MAXP><<<n_tiles, NPIX, smem, stream>>>(feats, bounds, tw, npay, out, last);
  return cudaGetLastError();
}

template <int MAXP>
cudaError_t launch_bwd(const float* feats, const int* bounds, const float* out, const int* last,
                       const float* gout, float* dfeats, int n_tiles, int tw, int npay,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * (NWARP + 1) * BWD_BATCH * (6 + npay);
  composite_bwd<MAXP><<<n_tiles, NPIX, smem, stream>>>(feats, bounds, tw, npay, out, last,
                                                       gout, dfeats);
  return cudaGetLastError();
}

}  // namespace

// feats (P, 6 + npay) f32 row-major; bounds (n_tiles + 1) i32; out
// (n_tiles, npay + 1, 256) f32; last (n_tiles, 256) i32. 1 <= npay <= 26.
extern "C" int mudg_tile_composite(const void* feats, const void* bounds, void* out, void* last,
                                   int n_tiles, int tw, int npay, void* stream) {
  if (npay < 1 || npay > MAX_PAY) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const float* f = static_cast<const float*>(feats);
  const int* b = static_cast<const int*>(bounds);
  float* o = static_cast<float*>(out);
  int* l = static_cast<int*>(last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npay <= 4) return launch_fwd<4>(f, b, o, l, n_tiles, tw, npay, s);
  if (npay <= 8) return launch_fwd<8>(f, b, o, l, n_tiles, tw, npay, s);
  if (npay <= 16) return launch_fwd<16>(f, b, o, l, n_tiles, tw, npay, s);
  return launch_fwd<MAX_PAY>(f, b, o, l, n_tiles, tw, npay, s);
}

// out and last as the forward wrote them; gout like out; dfeats like feats,
// zeroed by the caller.
extern "C" int mudg_tile_composite_bwd(const void* feats, const void* bounds, const void* out,
                                       const void* last, const void* gout, void* dfeats,
                                       int n_tiles, int tw, int npay, void* stream) {
  if (npay < 1 || npay > MAX_PAY) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const float* f = static_cast<const float*>(feats);
  const int* b = static_cast<const int*>(bounds);
  const float* o = static_cast<const float*>(out);
  const int* l = static_cast<const int*>(last);
  const float* g = static_cast<const float*>(gout);
  float* d = static_cast<float*>(dfeats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npay <= 4) return launch_bwd<4>(f, b, o, l, g, d, n_tiles, tw, npay, s);
  if (npay <= 8) return launch_bwd<8>(f, b, o, l, g, d, n_tiles, tw, npay, s);
  if (npay <= 16) return launch_bwd<16>(f, b, o, l, g, d, n_tiles, tw, npay, s);
  return launch_bwd<MAX_PAY>(f, b, o, l, g, d, n_tiles, tw, npay, s);
}
