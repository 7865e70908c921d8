// Kernel 9: the backward of one kernel-2 stage,
//   y = x + (softmax_T(LN(x) Wq' (LN(x) Wk)^T) LN(x) Wv) Wo + bo,
// (Wq' = Wq * d^-0.5 * log2(e), base-2 softmax over each 16-row sequence),
// giving dx and the fp32 gradients of the LN weight and bias, Wq' | Wk | Wv
// (one (3C, C) matrix; the wrapper rescales the Wq' rows to Wq), Wo and bo.
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
// Bound on this card: bytes, as the forward: each token attends to 16 others
// and every product has K = C or K = 16, except the weight gradients, which
// reduce over all rows (K = rows).
//
// Design: the TPU kernel adds each row block's weight gradients into fp32
// output blocks revisited by its sequential grid. Here:
//   1. per-row LN statistics; q'|k|v = LN(x) Wqkv'^T (the forward's GEMM);
//   2. dO = dy Wo (the GEMM with Wo^T packed by the wrapper);
//   3. the attention core, one block of 4 warps per (64 rows, head), a warp
//      per 16-row sequence: it re-forms P and the head's output o, then dP,
//      dS, dq = dS k and, from P and dS written to shared memory and read
//      transposed, dk = dS^T q' and dv = P^T dO;
//   4. the weight gradients as GEMMs over the rows (wgrad.cuh: bounded split,
//      fixed-order fp32 reduction, no atomics): dWqkv' = dqkv^T LN(x) with
//      the LN applied as the operand is loaded, dWo = dy^T o;
//   5. dLN(x) = dqkv Wqkv' in fp32, then the LN backward and the residual per
//      row, and the column sums for dLN weight, dLN bias and dbo.
// The (rows, 3C) q'|k|v and dq|dk|dv, the (rows, C) dO and o, and the fp32
// dLN(x) make one round trip through device memory each.
#include "attn.cuh"
#include "gemm.cuh"
#include "wgrad.cuh"

namespace mudg {

constexpr float TB_LN2 = 0.6931471805599453f;
constexpr int TB_PLD = 24;   // row stride of a warp's 16 x 16 P / dS tile

__global__ void __launch_bounds__(128)
    attn_blockdiag16_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                                bf16* __restrict__ o_all, bf16* __restrict__ dqkv, int c) {
  __shared__ __align__(16) bf16 qs[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 ks[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 vs[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 dos[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 ps[4][16 * TB_PLD];
  __shared__ __align__(16) bf16 dss[4][16 * TB_PLD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int h = blockIdx.y;
  const size_t row0 = (size_t)blockIdx.x * AT_ROWS;
  const int ld = 3 * c;
  const int r0 = warp * 16;   // this warp's sequence inside the tiles

  load_tile64(qs, qkv, row0, ld, h * 64);
  load_tile64(ks, qkv, row0, ld, c + h * 64);
  load_tile64(vs, qkv, row0, ld, 2 * c + h * 64);
  load_tile64(dos, dout, row0, c, h * 64);
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];
  load_q_frags(qf, qs, warp, g, q);
  load_q_frags(dof, dos, warp, g, q);

  // P: the forward's normalised base-2 softmax over the 16 keys
  float p[2][4];
  qk_logits<2>(p, qf, ks, r0, g, q);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float mx = quad_max(fmaxf(fmaxf(p[0][2 * hh], p[0][2 * hh + 1]),
                                    fmaxf(p[1][2 * hh], p[1][2 * hh + 1])));
    float sum = 0.f;
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      p[nj][2 * hh] = exp2f(p[nj][2 * hh] - mx);
      p[nj][2 * hh + 1] = exp2f(p[nj][2 * hh + 1] - mx);
      sum += p[nj][2 * hh] + p[nj][2 * hh + 1];
    }
    const float inv = 1.f / quad_sum(sum);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      p[nj][2 * hh] *= inv;
      p[nj][2 * hh + 1] *= inv;
    }
  }
  uint32_t pa[1][4];
  frag_from_acc(pa[0], p[0], p[1]);

  float acc[8][4];
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int dj = 0; dj < 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dj][e] = 0.f;
  mma_rowmajor_b<1>(acc, pa, vs, r0, g, q);   // o = P v (for dWo)
  store_o(o_all, c, row0 + r0, h * 64, acc, one, g, q);

  // dS = P * (dP - rowsum(P * dP)) * ln 2 (gradient of the base-2 logits)
  float ds[2][4];
  qk_logits<2>(ds, dof, vs, r0, g, q);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float d = quad_sum(p[0][2 * hh] * ds[0][2 * hh] + p[0][2 * hh + 1] * ds[0][2 * hh + 1] +
                             p[1][2 * hh] * ds[1][2 * hh] + p[1][2 * hh + 1] * ds[1][2 * hh + 1]);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      ds[nj][2 * hh] = p[nj][2 * hh] * (ds[nj][2 * hh] - d) * TB_LN2;
      ds[nj][2 * hh + 1] = p[nj][2 * hh + 1] * (ds[nj][2 * hh + 1] - d) * TB_LN2;
    }
  }
  uint32_t da[1][4];
  frag_from_acc(da[0], ds[0], ds[1]);
#pragma unroll
  for (int dj = 0; dj < 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dj][e] = 0.f;
  mma_rowmajor_b<1>(acc, da, ks, r0, g, q);   // dq' = dS k
  store_o(dqkv, ld, row0 + r0, h * 64, acc, one, g, q);

  // P and dS (bf16, [query][key]) to shared memory, read back transposed as
  // the A operands of dv = P^T dO and dk = dS^T q'
  bf16* pw = ps[warp];
  bf16* dw = dss[warp];
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int off = (g + 8 * hh) * TB_PLD + nj * 8 + 2 * q;
      *reinterpret_cast<uint32_t*>(pw + off) = pack_bf16x2(p[nj][2 * hh], p[nj][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dw + off) = pack_bf16x2(ds[nj][2 * hh], ds[nj][2 * hh + 1]);
    }
  __syncwarp();
  uint32_t pt[1][4], dt[1][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a0: (key g, queries 2q, 2q+1), a1: key g+8, a2: queries 2q+8, 2q+9, a3: both
    const int key = g + (i & 1) * 8, qr = 2 * q + (i >> 1) * 8;
    pt[0][i] = pack_pair(pw[qr * TB_PLD + key], pw[(qr + 1) * TB_PLD + key]);
    dt[0][i] = pack_pair(dw[qr * TB_PLD + key], dw[(qr + 1) * TB_PLD + key]);
  }
#pragma unroll
  for (int dj = 0; dj < 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dj][e] = 0.f;
  mma_rowmajor_b<1>(acc, dt, qs, r0, g, q);   // dk = dS^T q'
  store_o(dqkv, ld, row0 + r0, c + h * 64, acc, one, g, q);
#pragma unroll
  for (int dj = 0; dj < 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dj][e] = 0.f;
  mma_rowmajor_b<1>(acc, pt, dos, r0, g, q);  // dv = P^T dO
  store_o(dqkv, ld, row0 + r0, 2 * c + h * 64, acc, one, g, q);
}

}  // namespace mudg

using namespace mudg;

// One stage's backward. x, dy, dx: (rows, c) bf16, rows % 64 == 0, sequences
// of 16 consecutive rows. Weights: ln_w, ln_b (c) fp32; wqkv (3c, c) bf16 with
// the folded Wq'; wqkv_t (c, 3c) = wqkv^T and wo_t (c, c) = Wo^T bf16.
// Scratch: qkv, dqkv (rows, 3c) bf16; dout, o_all (rows, c) bf16; dxn (rows, c)
// fp32; mean, rstd (rows) fp32; work (work_elems fp32) for split partials.
// Outputs (fp32): dwqkv (3c, c), dwo (c, c), dlnw, dlnb, dbo (c).
extern "C" int mudg_temporal_attn_stage_bwd(
    const void* x, const void* dy, void* dx, void* qkv, void* dqkv, void* dout, void* o_all,
    void* dxn, void* mean, void* rstd, const void* ln_w, const void* ln_b, const void* wqkv,
    const void* wqkv_t, const void* wo_t, void* dwqkv, void* dwo, void* dlnw, void* dlnb,
    void* dbo, void* work, long long work_elems, int rows, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  float* wk = static_cast<float*>(work);
  cudaError_t err = launch_row_stats(xb, rows, c, 1e-5f, mu, rs, st);
  if (err != cudaSuccess) return err;

  GemmArgs p = gemm_args();   // q'|k|v = LN(x) Wqkv'^T
  p.a = xb;
  p.lda = c;
  p.b = static_cast<const bf16*>(wqkv);
  p.ldb = c;
  p.out = static_cast<bf16*>(qkv);
  p.ldo = 3 * c;
  p.m = rows;
  p.n = 3 * c;
  p.k = c;
  p.row_mean = mu;
  p.row_rstd = rs;
  p.ln_w = static_cast<const float*>(ln_w);
  p.ln_b = static_cast<const float*>(ln_b);
  err = launch_gemm<A_LN, E_BIAS>(p, st);
  if (err != cudaSuccess) return err;

  p = gemm_args();   // dO = dy Wo
  p.a = dyb;
  p.lda = c;
  p.b = static_cast<const bf16*>(wo_t);
  p.ldb = c;
  p.out = static_cast<bf16*>(dout);
  p.ldo = c;
  p.m = rows;
  p.n = c;
  p.k = c;
  err = launch_gemm<A_PLAIN, E_BIAS>(p, st);
  if (err != cudaSuccess) return err;

  attn_blockdiag16_bwd_kernel<<<dim3(rows / AT_ROWS, c / 64), 128, 0, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<bf16*>(o_all), static_cast<bf16*>(dqkv), c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  WgradArgs w = wgrad_args(dqkv, 3 * c, x, c, 3 * c, c, rows);   // dWqkv' = dqkv^T LN(x)
  w.row_mean = mu;
  w.row_rstd = rs;
  w.ln_w = static_cast<const float*>(ln_w);
  w.ln_b = static_cast<const float*>(ln_b);
  err = launch_wgrad<B_LN>(w, static_cast<float*>(dwqkv), wk, work_elems, st);
  if (err != cudaSuccess) return err;
  w = wgrad_args(dy, c, o_all, c, c, c, rows);   // dWo = dy^T o
  err = launch_wgrad<B_PLAIN>(w, static_cast<float*>(dwo), wk, work_elems, st);
  if (err != cudaSuccess) return err;

  p = gemm_args();   // dLN(x) = dqkv Wqkv', fp32
  p.a = static_cast<const bf16*>(dqkv);
  p.lda = 3 * c;
  p.b = static_cast<const bf16*>(wqkv_t);
  p.ldb = 3 * c;
  p.outf = static_cast<float*>(dxn);
  p.ldo = c;
  p.m = rows;
  p.n = c;
  p.k = 3 * c;
  err = launch_gemm<A_PLAIN, E_F32>(p, st);
  if (err != cudaSuccess) return err;

  const float* dxnf = static_cast<const float*>(dxn);
  err = launch_ln_bwd(xb, dyb, dxnf, mu, rs, static_cast<const float*>(ln_w), rows, c,
                      static_cast<bf16*>(dx), st);
  if (err != cudaSuccess) return err;
  err = launch_colsum<C_XHAT>(dxnf, rows, c, static_cast<float*>(dlnw), wk, work_elems, st,
                              xb, mu, rs);
  if (err != cudaSuccess) return err;
  err = launch_colsum<C_F32>(dxnf, rows, c, static_cast<float*>(dlnb), wk, work_elems, st);
  if (err != cudaSuccess) return err;
  return launch_colsum<C_BF16>(dy, rows, c, static_cast<float*>(dbo), wk, work_elems, st);
}
