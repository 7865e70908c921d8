// Kernel 1: the whole pre-LN spatial self-attention residual block,
//   out = x + (softmax(LN(x) Wq (LN(x) Wk)^T / sqrt(d)) LN(x) Wv) Wo + bo,
// over x (B*T, L, C), heads of d = 64.
//
// Replaces: mudg_tpu/kernels/spatial_attn.py:_kernel (fused_self_attention,
// pallas_call at :163) and, at MDM1024, its two long-L tiers of the same
// function: _stream_kernel (pallas_call at :365, ds2 L=2304, C=640) and
// _fb_kernel (pallas_call at :550, ds1 L=9216, C=320). Those tiers exist
// because the TPU's kernel holds a whole sequence in VMEM; this one streams
// K/V through shared memory at any L % 64 == 0, so one kernel serves all.
//
// Bound on this card: at MDM512 ds1 (32 x 2560 x 320, 5 heads) the attention
// core is 2*2*32*5*2560^2*64 = 268 GFLOP against ~50 MB of q/k/v traffic, so it
// is bound by tensor-core issue, not bytes; the projections are short-K GEMMs
// (K = C = 320 or 640) bound by bytes. At MDM1024 the core grows with L^2:
// 3.48 TFLOP at ds1 (32 x 9216 x 320), 0.43 TFLOP at ds2 (32 x 2304 x 640).
//
// Offsets: every element offset is formed in size_t (the LayerNorm rows,
// the flash core's output rows) or held by TMA as per-dimension int32
// coordinates (the GEMMs' rows, the core's (batch, row, head)); the int
// values are row counts and grid indices. At a 3-task, 3-variant MDM1024
// batch (144 frames of 9216 tokens) the q|k|v scratch holds 1.27e9
// elements, under 2^31 but not by much, and rows = 1.33e6 stays far inside
// int.
//
// Design: four launches on the port's Hopper machinery, instead of the TPU's
// one, because one SM cannot hold a whole 2560-token K/V the way VMEM can.
//   1. xn = LN(x) in bf16 by kernel 11's LayerNorm body (TMA cannot
//      normalise on its way into shared memory);
//   2. q|k|v = xn Wqkv^T (N = 3C, no bias) on the persistent TMA + wgmma
//      GEMM (wgmma_gemm.cuh); Wq carries the folded d^-0.5*log2(e) in bf16,
//      as in the TPU kernel;
//   3. the FlashAttention-3-shaped core of flash_fwd.cuh reading q, k and v
//      in place from the (B, L, 3C) scratch through their strides, with
//      qscale = 1 (the scale is already in Wq; q times 1.0 rounds to
//      itself, so the numerics stay the TPU kernel's) and no logsumexp;
//   4. out = o Wo^T + bo + x on the same GEMM, the residual read by TMA.
// The attention output o reuses xn's scratch (xn is dead once step 2 has
// read it). xn, q|k|v and o each make one round trip through device
// memory; fusing the out-projection into the core's epilogue (one block
// holding all heads of 128 rows) would save o's.
#include "flash_fwd.cuh"
#include "wgmma_gemm.cuh"

using namespace mudg;

extern "C" int mudg_layer_norm(const void* x, void* y, const void* w, const void* b, int rows,
                               int c, int fp32, float eps, void* stream);

// x, out: (batch*seq, c) bf16. Scratch: xn (batch*seq, c) bf16, which also
// takes the attention output, and qkv (batch*seq, 3c) bf16. Weights: ln_w,
// ln_b, bo fp32 (c); wqkv (3c, c) bf16 with the softmax scale folded into
// its first c rows; wo (c, c) bf16. seq % 64 == 0, c % 64 == 0.
extern "C" int mudg_spatial_attn(const void* x, void* out, void* xn, void* qkv,
                                 const void* ln_w, const void* ln_b, const void* wqkv,
                                 const void* wo, const void* bo, int batch, int seq, int c,
                                 void* stream) {
  if (seq % 64 || c % 64) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = batch * seq;
  cudaError_t err =
      static_cast<cudaError_t>(mudg_layer_norm(x, xn, ln_w, ln_b, rows, c, 0, 1e-5f, stream));
  if (err != cudaSuccess) return err;
  bf16* xb = static_cast<bf16*>(xn);
  bf16* qb = static_cast<bf16*>(qkv);
  err = launch_wgmma_gemm<WG_BIAS>(xb, c, static_cast<const bf16*>(wqkv), c, qb, 3 * c,
                                   nullptr, 0, nullptr, rows, 3 * c, c, 0, st);
  if (err != cudaSuccess) return err;
  // q, k, v: (batch, seq, heads, 64) at column offsets 0, c, 2c of each row
  const long long sb = (long long)seq * 3 * c, sl = 3 * c;
  err = launch_flash_fwd<false>(qb, sb, sl, 64, qb + c, sb, sl, 64, qb + 2 * c, sb, sl, 64, xb,
                                nullptr, batch, seq, c / 64, 1.f, st);
  if (err != cudaSuccess) return err;
  return launch_wgmma_gemm<WG_BIAS_RES>(xb, c, static_cast<const bf16*>(wo), c,
                                        static_cast<bf16*>(out), c, static_cast<const bf16*>(x),
                                        c, static_cast<const float*>(bo), rows, c, c, 0, st);
}

extern "C" const char* mudg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
