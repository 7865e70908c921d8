// Kernel 10: the backward of the bare GEGLU feed-forward (kernel 3 without
// its LN and residual), y = (u * gelu_erf(g)) W2^T + b2, [u | g] = x W1^T + b1:
//   dh = dy W2,  du = dh * gelu(g),  dg = dh * u * (Phi(g) + g * pdf(g)),
//   dx = [du | dg] W1,  dW1 = [du | dg]^T x,  db1 = colsum [du | dg],
//   dW2 = dy^T h (h = u * gelu(g)),  db2 = colsum dy,
// in the torch layouts W1 (2*inner, C) [value | gate], W2 (C, inner); weight
// and bias gradients fp32.
//
// Replaces: mudg_tpu/kernels/mlp.py:_ff_bwd_kernel (_ff_bwd_apply,
// pallas_call at :438). Numerics as there (:341-385): u, g and dh in fp32,
// erf GELU and the normal pdf in fp32, h, du and dg rounded to bf16 for their
// products, the bias gradients summed from the fp32 du and dg. For the block
// form the wrapper recomputes LN(x), feeds it here and takes the LN's
// backward and the residual in torch, as the JAX package does (:271-304).
//
// Bound on this card: tensor-core issue. The function needs 8 M x C x inner
// multiply-adds (u and g recomputed, dh, dx twice inner wide, dW2, dW1 twice
// inner wide): at MDM512 ds1 (40960 x 320, inner 1280) 16 * 40960 * 320 *
// 1280 = 268 GFLOP over ~79 MB of x, dy, dx and the weights.
//
// Design: the TPU kernel keeps the (M, inner) intermediates in VMEM and adds
// each row block into revisited weight-gradient blocks. Here, four products
// on the port's TMA + wgmma machinery and two column sums:
//   1. u | g = x W1^T + b1 and dh = dy W2 in one tile of 64 rows x 64
//      columns j (wgmma_gemm.cuh's WG_GEGLU_BWD: W1's value and gate rows
//      of j against x, W2^T's rows j against dy as a second A operand, 96
//      accumulators a thread), whose epilogue forms h, du and dg in
//      registers, stores h and [du | dg] in bf16 and the tile's fp32 column
//      sums of du and dg for db1. dh never leaves the SM: the alternative, a
//      GEMM storing dh in fp32, moves 8 bytes per (row, j) more (1.5 GB per
//      MDM1024 ds1 call, ~0.45 ms at the card's rate).
//   2. dx = [du | dg] W1 on the persistent GEMM (WG_BIAS, K = 2*inner; the
//      wrapper packs W1^T).
//   3. dW2 = dy^T h and dW1 = [du | dg]^T x on wgmma_wgrad.cuh: both
//      operands as they lie, read by wgmma through its transpose bits; a
//      bounded split over the rows with a fixed-order sum, no atomics.
//   4. db1 from the tiles' column sums and db2 = colsum dy, both in fixed
//      order (reduce.cuh).
// Every sum runs in an order fixed by the shapes: reruns are bit for bit.
// Unlike the TPU kernel, h and [du | dg] (bf16) make one round trip through
// device memory: keeping them on chip needs the dW accumulators of a whole
// inner chunk in one SM.
#include "wgmma_gemm.cuh"
#include "wgmma_wgrad.cuh"

using namespace mudg;

// x, dy, dx: (rows, c) bf16; w1 (2*inner, c) bf16, b1 (2*inner) fp32,
// w2t (inner, c) = W2^T bf16, w1t (c, 2*inner) = W1^T bf16. Scratch: h
// (rows, inner) bf16, dudg (rows, 2*inner) bf16, slab (ceil(rows/64),
// 2*inner) fp32, work (work_elems fp32). Outputs (fp32): dw1 (2*inner, c),
// db1 (2*inner), dw2 (c, inner), db2 (c). c % 8 == 0, inner % 64 == 0.
extern "C" int mudg_geglu_ff_bwd(const void* x, const void* dy, void* dx, const void* w1,
                                 const void* b1, const void* w2t, const void* w1t, void* h,
                                 void* dudg, void* slab, void* dw1, void* db1, void* dw2,
                                 void* db2, void* work, long long work_elems, int rows, int c,
                                 int inner, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  bf16* hb = static_cast<bf16*>(h);
  bf16* dudgb = static_cast<bf16*>(dudg);
  float* wk = static_cast<float*>(work);

  cudaError_t err = launch_wgmma_geglu_bwd(   // h, [du | dg] and their column sums
      xb, dyb, static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2t), hb, dudgb, static_cast<float*>(slab), rows, c, inner, st);
  if (err != cudaSuccess) return err;
  err = launch_wgmma_gemm<WG_BIAS>(dudgb, 2 * inner, static_cast<const bf16*>(w1t), 2 * inner,
                                   static_cast<bf16*>(dx), c, nullptr, 0, nullptr, rows, c,
                                   2 * inner, 0, st);   // dx = [du | dg] W1
  if (err != cudaSuccess) return err;
  err = launch_wgmma_wgrad(dyb, c, hb, inner, c, inner, rows, static_cast<float*>(dw2), wk,
                           work_elems, st);   // dW2 = dy^T h
  if (err != cudaSuccess) return err;
  err = launch_wgmma_wgrad(dudgb, 2 * inner, xb, c, 2 * inner, c, rows,
                           static_cast<float*>(dw1), wk, work_elems, st);   // dW1 = [du | dg]^T x
  if (err != cudaSuccess) return err;
  err = launch_colsum<C_F32>(slab, (rows + 63) / 64, 2 * inner, static_cast<float*>(db1), wk,
                             work_elems, st);
  if (err != cudaSuccess) return err;
  return launch_colsum<C_BF16>(dy, rows, c, static_cast<float*>(db2), wk, work_elems, st);
}
