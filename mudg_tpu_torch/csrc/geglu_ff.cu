// Kernel 3: the GEGLU feed-forward,
//   out = [x +] (u * gelu_erf(g)) W2 + b2,  [u | g] = [LN](x) W1 + b1,
// with W1's columns [value | gate] (value first), in two variants: with the
// pre-LN and the residual (the block form) and without either.
//
// Replaces: mudg_tpu/kernels/mlp.py:_ff_ln_kernel (fused_geglu_ff_block,
// pallas_call at :235) and :_ff_kernel (fused_geglu_ff, :189).
//
// Bound on this card: tensor-core issue. Every MuDG site is about 200 GFLOP
// (MDM512 ds1: 6 * 81920 * 320 * 1280 = 201 GFLOP, 0.203 ms at 989
// TFLOP/s, against 52 MB of x and out, 16 us at 3.35 TB/s). The two-GEMM
// design also writes and re-reads h (M, 4C): at MDM512 ds1 210 MB, 63 us,
// about a third of the products' time, and the LN pass below moves 2 M C
// bf16 more (105 MB).
//
// Design: three launches on one TMA + wgmma GEMM (wgmma_gemm.cuh).
//   1. block form only: xn = LN(x) in bf16 by kernel 11's LayerNorm body
//      (fp32 mean and centered variance, rounded to bf16 as the reference
//      rounds its xn). TMA cannot normalise on the way into shared memory;
//      normalising in the consumers' registers and feeding wgmma's register
//      A operand would save this pass (2 * M * C * 2 bytes: 105 MB, 31 us
//      at MDM512 ds1) but recompute the LN for every column block of W1.
//   2. h = GEGLU(xn W1 + b1): each 128 x 64 tile of h multiplies W1's 64
//      value rows n0.. and 64 gate rows inner + n0.., loaded as one 128-row
//      B slab, and stores only h, so the (M, 8C) [u | g] product never
//      reaches device memory.
//   3. out = h W2^T + b2 [+ x], the residual read by TMA in the epilogue.
// Both GEMMs are persistent: one block per SM (or per tile, if fewer) walks
// the tiles, its two consumer warpgroups taking turns. N = C in GEMM 3 is
// cut in 128-column blocks, so C = 320 computes 384 columns (the last block
// half empty, clipped on store).
#include "wgmma_gemm.cuh"

using namespace mudg;

extern "C" int mudg_layer_norm(const void* x, void* y, const void* w, const void* b, int rows,
                               int c, int fp32, float eps, void* stream);

// x, out: (rows, c) bf16; h (rows, inner) bf16 scratch; xn (rows, c) bf16
// scratch of the block form; w1 (2*inner, c) bf16, b1 (2*inner) fp32; w2
// (c, inner) bf16, b2 (c) fp32. With ln_w non-null the LN and the residual
// are applied. rows >= 1 (any count: TMA's zero fill and clipped stores
// cover a partial row tile), c % 32 == 0, inner % 128 == 0.
extern "C" int mudg_geglu_ff(const void* x, void* out, void* h, void* xn, const void* ln_w,
                             const void* ln_b, const void* w1, const void* b1, const void* w2,
                             const void* b2, int rows, int c, int inner, void* stream) {
  if (rows < 1 || c % 32 || inner % 128) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool block = ln_w != nullptr;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* a = xb;
  if (block) {
    const cudaError_t err =
        static_cast<cudaError_t>(mudg_layer_norm(x, xn, ln_w, ln_b, rows, c, 0, 1e-5f, stream));
    if (err != cudaSuccess) return err;
    a = static_cast<const bf16*>(xn);
  }
  cudaError_t err = launch_wgmma_gemm<WG_GEGLU>(
      a, c, static_cast<const bf16*>(w1), c, static_cast<bf16*>(h), inner, nullptr, 0,
      static_cast<const float*>(b1), rows, inner, c, inner, st);
  if (err != cudaSuccess) return err;
  if (block)
    return launch_wgmma_gemm<WG_BIAS_RES>(static_cast<const bf16*>(h), inner,
                                          static_cast<const bf16*>(w2), inner,
                                          static_cast<bf16*>(out), c, xb, c,
                                          static_cast<const float*>(b2), rows, c, inner, 0, st);
  return launch_wgmma_gemm<WG_BIAS>(static_cast<const bf16*>(h), inner,
                                    static_cast<const bf16*>(w2), inner, static_cast<bf16*>(out),
                                    c, nullptr, 0, static_cast<const float*>(b2), rows, c, inner,
                                    0, st);
}
