// Kernel 4: one TemporalConvBlock stage, GroupNorm -> SiLU -> Conv3d (3,1,1)
// with zero padding in t, over a video x (B, T, H, W, C):
//   out[b, t] = bias + sum_tap silu(GN(x)[b, t + tap - 1]) W_tap
// with the GroupNorm's 32 groups over (T*H*W, C/32) of each clip.
//
// Replaces: mudg_tpu/kernels/tconv.py:_kernel (fused_gn_silu_tconv,
// pallas_call at :128). The TPU folds the statistics outside its kernel
// (tconv.py:gn_fold) into per-(B, C) scale and shift; here they are taken
// on the card by kernel 11's GroupNorm statistics pass.
//
// Bound on this card: tensor-core issue. At MDM512 ds1 a stage is
// 2*81920*960*320 = 50 GFLOP over ~105 MB of x and out.
//
// Design: kernel 11's GroupNorm with SiLU, then the persistent TMA + wgmma
// GEMM. kernels/norms.py:gn_plan chooses the GroupNorm's path by shape:
//   1. one launch (norms.cu's gn_cluster_kernel) where a thread-block
//      cluster holds a clip in shared memory; the clips the model gives
//      kernel 4 (C = 320 at ds1: 13.1M elements at MDM512, 47M at MDM1024)
//      are larger and take two, the statistics (gn_stats, per-chunk Welford
//      partials) and the apply pass (gn_apply). Both paths work on x minus
//      each group's first element and merge by Chan's formula in a fixed
//      order, so reruns are bit for bit and a DC offset does not cancel; no
//      fp32 copy of x.
//   2. h = silu(GN(x)): the affine from the merged statistics and the GN
//      weight and bias, in fp32, rounded to bf16 once, as the Pallas kernel
//      feeds its MXU (tconv.py:25-27). h is one more write and read of M x
//      C bf16 (0.11 ms at MDM1024 ds1); a transform warpgroup normalising
//      between TMA and wgmma would save it.
//   3. out = bias + [h_{t-1} | h_t | h_{t+1}] wcat^T, K = 3 taps x C, on
//      wgmma_gemm.cuh's WG_TAP3 source: A through a 4-D tensor map (C, HW,
//      T, B) whose zero fill outside [0, T) is the conv's padding, the
//      weight through a 3-D map (C_in, 3, C_out), tiles of 128 HW rows
//      inside one frame. The weight is prepared once as (C, 3C):
//      wcat[o, tap*C + i] = W[o, i, tap].
#include "wgmma_gemm.cuh"

using namespace mudg;

// out[b, t] = bias + sum_tau h[b, t + tau - 1] wcat[:, tau, :]^T, zero
// where t + tau - 1 falls outside [0, frames): the WG_TAP3 source with the
// WG_BIAS epilogue. h, out: (batch, frames, hw, c) bf16; wcat (c, 3c) bf16
// with wcat[o, tau * c + i] = W[o, i, tau]; bias (c) fp32. c % 8 == 0
// (16-byte strides), any hw >= 1.
static cudaError_t launch_wgmma_tap3(const bf16* h, const bf16* wcat, bf16* out,
                                     const float* bias, int batch, int frames, int hw, int c,
                                     cudaStream_t stream) {
  using mudg_host::bf16_map;
  const cuuint64_t cs = (cuuint64_t)c * 2;
  const cuuint64_t vdims[4] = {(cuuint64_t)c, (cuuint64_t)hw, (cuuint64_t)frames,
                               (cuuint64_t)batch};
  const cuuint64_t vstrides[3] = {cs, cs * hw, cs * hw * frames};
  const cuuint32_t vbox[4] = {64, WG_BM, 1, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)c, 3, (cuuint64_t)c};
  const cuuint64_t wstrides[2] = {cs, 3 * cs};
  const cuuint32_t wbox[3] = {64, 1, 128};
  CUtensorMap ta, tb, tout;
  cudaError_t e = bf16_map(&ta, h, 4, vdims, vstrides, vbox);
  if (e == cudaSuccess) e = bf16_map(&tb, wcat, 3, wdims, wstrides, wbox);
  if (e == cudaSuccess) e = bf16_map(&tout, out, 4, vdims, vstrides, vbox);
  if (e != cudaSuccess) return e;
  WgGemmArgs p = {};
  p.bias = bias;
  p.n = c;
  p.kc = (c + 63) / 64;
  p.nk = 3 * p.kc;
  p.frames = frames;
  p.hw_tiles = (hw + WG_BM - 1) / WG_BM;
  p.n_tiles = (c + 127) / 128;
  p.tiles = batch * frames * p.hw_tiles * p.n_tiles;
  return wg_launch<WG_BIAS, WG_TAP3>(ta, tb, tout, ta, p, stream);
}

extern "C" int mudg_group_norm_silu(const void* x, void* y, const void* w, const void* b,
                                    void* part, int n, int rows, int c, int groups, int cluster,
                                    int per, int keep, int chunks, float eps, void* stream);

// x, out: (batch, frames, hw, c) bf16; h: the same, scratch; each clip's
// frames*hw rows planned as mudg_group_norm takes them (kernels/norms.py:
// gn_plan): cluster > 0, one cluster of `cluster` CTAs of `per` rows per
// clip, `keep` of each in shared memory (part may be null); else `chunks`
// chunks of `per` rows and part batch * chunks * 32 (mean, M2) fp32 pairs
// of scratch; gn_w, gn_b: (c) fp32; wcat (c, 3c) bf16; bias (c) fp32.
// c % 32 == 0, frames >= 1, any hw.
extern "C" int mudg_gn_silu_tconv(const void* x, void* out, void* h, void* part,
                                  const void* gn_w, const void* gn_b, const void* wcat,
                                  const void* bias, int batch, int frames, int hw, int c,
                                  int cluster, int per, int keep, int chunks, void* stream) {
  if (c % 32 || frames < 1 || hw < 1) return cudaErrorInvalidValue;
  cudaError_t err = static_cast<cudaError_t>(mudg_group_norm_silu(
      x, h, gn_w, gn_b, part, batch, frames * hw, c, 32, cluster, per, keep, chunks, 1e-5f,
      stream));
  if (err != cudaSuccess) return err;
  return launch_wgmma_tap3(static_cast<const bf16*>(h), static_cast<const bf16*>(wcat),
                           static_cast<bf16*>(out), static_cast<const float*>(bias), batch,
                           frames, hw, c, static_cast<cudaStream_t>(stream));
}
