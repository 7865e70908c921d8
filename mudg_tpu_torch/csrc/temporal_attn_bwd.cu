// Kernel 9: the backward of one kernel-2 stage,
//   y = x + (softmax_T(LN(x) Wq' (LN(x) Wk)^T) LN(x) Wv) Wo + bo,
// (Wq' = Wq * d^-0.5 * log2(e), base-2 softmax over each 16-row sequence),
// giving dx and the fp32 gradients of the LN weight and bias, Wq' | Wk | Wv
// (one (3C, C) matrix in the head order of kernel 2's packing; the wrapper
// restores [q | k | v] order and rescales the Wq' rows to Wq), Wo and bo.
// The wrapper runs it for stage 2 on the saved stage-1 output h1, then for
// stage 1 on the tokens.
//
// Replaces: mudg_tpu/kernels/temporal_attn.py:_bwd_stage_kernel
// (_bwd_one_stage, pallas_call at :406). Numerics as there (:265-369): LN,
// q' | k | v and the recomputed per-head output rounded to bf16; dy @ Wo^T
// rounded to bf16; dS = P (dP - rowsum(P dP)) ln 2 rounded to bf16; dq, dk,
// dv rounded to bf16 before the weight gradients and dLN(x); the LN backward
// in fp32.
//
// Bound on this card: operations. Per row the function does 11 C x C
// multiply-adds (q'|k|v, dO, the two weight gradients, dLN(x)), 2.3 MFLOP
// at C = 320 (2.3 ns at 989 TFLOP/s), against 6 C bytes of x, dy and dx
// (0.6 ns at 3.35 TB/s). This design's intermediates (xn, dO, o, dq'|dk|dv
// and the fp32 dLN(x), each written once and read once to three times) move
// about 50 C bytes a row more, 4.8 ns at C = 320: in practice it is bound
// by bytes.
//
// Design: the TPU kernel keeps a row block's intermediates in VMEM and adds
// its weight gradients into fp32 output blocks revisited by its sequential
// grid. Here, one stage is these launches on the port's TMA + wgmma
// machinery, every sum in an order fixed by the shapes (no atomics: reruns
// are bit for bit):
//   1. xn = LN(x) in bf16 and each row's fp32 mean and rstd, by kernel 11's
//      LayerNorm body (mudg_layer_norm_stats);
//   2. dO = dy Wo on the persistent GEMM (wgmma_gemm.cuh, WG_BIAS with no
//      bias; the wrapper packs Wo^T);
//   3. the attention backward as the epilogue of the q'|k|v GEMM
//      (WG_TATTN_BWD): a tile is 64 rows (four whole sequences) by one
//      head's 192 rows of the head-ordered Wqkv' = [Wq'_h | Wk_h | Wv_h],
//      q'_h, k_h and v_h recomputed in registers, the head's dO slice
//      loaded by TMA, and each warp's sequence's P, o, dP, dS, dq', dk and
//      dv formed in registers by mma.sync (movmatrix transposes); only o
//      and [dq' | dk | dv] (bf16) leave, so q'|k|v never reach device
//      memory;
//   4. the weight gradients over the rows on wgmma_wgrad.cuh, from the
//      materialised xn: dWqkv' = dqkv^T xn, dWo = dy^T o (bounded split,
//      fixed-order sum of the partials);
//   5. dLN(x) = dqkv Wqkv' in fp32 on the persistent GEMM (WG_F32; the
//      wrapper packs Wqkv'^T), then the LN backward and the residual per row
//      (ln_bwd_kernel) and the column sums for dLN weight, dLN bias and dbo
//      (reduce.cuh).
// xn, dO, o and dqkv (bf16) and dLN(x) (fp32) make one round trip through
// device memory each.
#include "wgmma_gemm.cuh"
#include "wgmma_wgrad.cuh"

namespace mudg {

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

}  // namespace mudg

using namespace mudg;

extern "C" int mudg_layer_norm_stats(const void* x, void* y, const void* w, const void* b,
                                     void* mean, void* rstd, int rows, int c, float eps,
                                     void* stream);

// One stage's backward. x, dy, dx: (rows, c) bf16, rows % 64 == 0, sequences
// of 16 consecutive rows, c % 64 == 0. Weights: ln_w, ln_b (c) fp32; wqkv
// (3c, c) bf16 in head order with the folded Wq' (kernel 2's packing);
// wqkv_t (c, 3c) = wqkv^T and wo_t (c, c) = Wo^T bf16. Scratch: xn, dout, o
// (rows, c) bf16; dqkv (rows, 3c) bf16; dxn (rows, c) fp32; mean, rstd
// (rows) fp32; work (work_elems fp32) for split partials. Outputs (fp32):
// dwqkv (3c, c) in head order, dwo (c, c), dlnw, dlnb, dbo (c).
extern "C" int mudg_temporal_attn_stage_bwd(
    const void* x, const void* dy, void* dx, void* xn, void* dout, void* o, void* dqkv,
    void* dxn, void* mean, void* rstd, const void* ln_w, const void* ln_b, const void* wqkv,
    const void* wqkv_t, const void* wo_t, void* dwqkv, void* dwo, void* dlnw, void* dlnb,
    void* dbo, void* work, long long work_elems, int rows, int c, void* stream) {
  if (rows % 64 || c % 64) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  bf16* xnb = static_cast<bf16*>(xn);
  bf16* dob = static_cast<bf16*>(dout);
  bf16* ob = static_cast<bf16*>(o);
  bf16* dqkvb = static_cast<bf16*>(dqkv);
  float* dxnf = static_cast<float*>(dxn);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  float* wk = static_cast<float*>(work);
  cudaError_t err = static_cast<cudaError_t>(
      mudg_layer_norm_stats(x, xn, ln_w, ln_b, mean, rstd, rows, c, 1e-5f, stream));
  if (err != cudaSuccess) return err;
  err = launch_wgmma_gemm<WG_BIAS>(dyb, c, static_cast<const bf16*>(wo_t), c, dob, c, nullptr,
                                   0, nullptr, rows, c, c, 0, st);   // dO = dy Wo
  if (err != cudaSuccess) return err;
  err = launch_wgmma_tattn_bwd(xnb, static_cast<const bf16*>(wqkv), dob, ob, dqkvb, rows, c, st);
  if (err != cudaSuccess) return err;
  err = launch_wgmma_wgrad(dqkvb, 3 * c, xnb, c, 3 * c, c, rows, static_cast<float*>(dwqkv), wk,
                           work_elems, st);   // dWqkv' = dqkv^T xn
  if (err != cudaSuccess) return err;
  err = launch_wgmma_wgrad(dyb, c, ob, c, c, c, rows, static_cast<float*>(dwo), wk, work_elems,
                           st);   // dWo = dy^T o
  if (err != cudaSuccess) return err;
  err = launch_wgmma_gemm_f32(dqkvb, 3 * c, static_cast<const bf16*>(wqkv_t), 3 * c, dxnf, c,
                              rows, c, 3 * c, st);   // dLN(x) = dqkv Wqkv', fp32
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<<<(rows + 7) / 8, 256, 0, st>>>(xb, dyb, dxnf, mu, rs,
                                                static_cast<const float*>(ln_w), rows, c,
                                                static_cast<bf16*>(dx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_colsum<C_XHAT>(dxnf, rows, c, static_cast<float*>(dlnw), wk, work_elems, st, xb,
                              mu, rs);
  if (err != cudaSuccess) return err;
  err = launch_colsum<C_F32>(dxnf, rows, c, static_cast<float*>(dlnb), wk, work_elems, st);
  if (err != cudaSuccess) return err;
  return launch_colsum<C_BF16>(dy, rows, c, static_cast<float*>(dbo), wk, work_elems, st);
}
