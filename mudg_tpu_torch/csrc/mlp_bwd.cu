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
// each row block into revisited weight-gradient blocks. Here, as five GEMM
// launches of the port's template:
//   1. dh = dy W2 in fp32 (the wrapper packs W2^T);
//   2. x W1^T with the value and gate columns of one j in one warp (kernel 3's
//      GEGLU tile), whose epilogue reads dh and forms h, du, dg in registers
//      and the per-slab column sums of du and dg for db1;
//   3. dx = [du | dg] W1 (the wrapper packs W1^T);
//   4. dW2 = dy^T h and dW1 = [du | dg]^T x as weight-gradient GEMMs over the
//      rows (wgrad.cuh: bounded split, fixed-order fp32 reduction, no atomics:
//      deterministic);
//   5. db1 from the slab sums and db2 = colsum dy, both in fixed order.
// Unlike the TPU kernel, dh (fp32) and h, du, dg (bf16) make one round trip
// through device memory: keeping them on chip needs the dW accumulators of a
// whole inner chunk in one SM, which is later work.
#include "gemm.cuh"
#include "wgrad.cuh"

using namespace mudg;

// x, dy, dx: (rows, c) bf16; w1 (2*inner, c) bf16, b1 (2*inner) fp32,
// w2t (inner, c) = W2^T bf16, w1t (c, 2*inner) = W1^T bf16. Scratch: dh
// (rows, inner) fp32, h (rows, inner) bf16, dudg (rows, 2*inner) bf16,
// slab (2*ceil(rows/128), 2*inner) fp32, work (work_elems fp32). Outputs
// (fp32): dw1 (2*inner, c), db1 (2*inner), dw2 (c, inner), db2 (c).
// c % 32 == 0, inner % 64 == 0, rows % 32 == 0.
extern "C" int mudg_geglu_ff_bwd(const void* x, const void* dy, void* dx, const void* w1,
                                 const void* b1, const void* w2t, const void* w1t, void* dh,
                                 void* h, void* dudg, void* slab, void* dw1, void* db1,
                                 void* dw2, void* db2, void* work, long long work_elems,
                                 int rows, int c, int inner, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);

  GemmArgs p = gemm_args();   // dh = dy W2
  p.a = static_cast<const bf16*>(dy);
  p.lda = c;
  p.b = static_cast<const bf16*>(w2t);
  p.ldb = c;
  p.outf = static_cast<float*>(dh);
  p.ldo = inner;
  p.m = rows;
  p.n = inner;
  p.k = c;
  cudaError_t err = launch_gemm<A_PLAIN, E_F32>(p, st);
  if (err != cudaSuccess) return err;

  p = gemm_args();   // u, g = x W1^T + b1 -> h, du, dg
  p.a = static_cast<const bf16*>(x);
  p.lda = c;
  p.b = static_cast<const bf16*>(w1);
  p.ldb = c;
  p.out = static_cast<bf16*>(h);
  p.ldo = inner;
  p.m = rows;
  p.n = 2 * inner;
  p.k = c;
  p.bias = static_cast<const float*>(b1);
  p.inner = inner;
  p.dh = static_cast<const float*>(dh);
  p.out2 = static_cast<bf16*>(dudg);
  p.part = static_cast<float*>(slab);
  err = launch_gemm<A_PLAIN, E_GEGLU_BWD>(p, st);
  if (err != cudaSuccess) return err;

  p = gemm_args();   // dx = [du | dg] W1
  p.a = static_cast<const bf16*>(dudg);
  p.lda = 2 * inner;
  p.b = static_cast<const bf16*>(w1t);
  p.ldb = 2 * inner;
  p.out = static_cast<bf16*>(dx);
  p.ldo = c;
  p.m = rows;
  p.n = c;
  p.k = 2 * inner;
  err = launch_gemm<A_PLAIN, E_BIAS>(p, st);
  if (err != cudaSuccess) return err;

  WgradArgs w = wgrad_args(dy, c, h, inner, c, inner, rows);   // dW2 = dy^T h
  err = launch_wgrad<B_PLAIN>(w, static_cast<float*>(dw2), wk, work_elems, st);
  if (err != cudaSuccess) return err;
  w = wgrad_args(dudg, 2 * inner, x, c, 2 * inner, c, rows);   // dW1 = [du | dg]^T x
  err = launch_wgrad<B_PLAIN>(w, static_cast<float*>(dw1), wk, work_elems, st);
  if (err != cudaSuccess) return err;

  const int slabs = 2 * ((rows + GBM - 1) / GBM);
  err = launch_colsum<C_F32>(slab, slabs, 2 * inner, static_cast<float*>(db1), wk, work_elems,
                             st);
  if (err != cudaSuccess) return err;
  return launch_colsum<C_BF16>(dy, rows, c, static_cast<float*>(db2), wk, work_elems, st);
}
