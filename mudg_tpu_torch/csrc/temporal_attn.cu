// Kernel 2: one stage of the temporal transformer's double self-attention,
//   out = x + (softmax_T(LN(x) Wq (LN(x) Wk)^T / sqrt(d)) LN(x) Wv) Wo + bo,
// over tokens (N*T, C) where each sequence is T = 16 consecutive rows. The
// wrapper runs it twice, stage 1 then stage 2, for one dispatch site.
//
// Replaces: mudg_tpu/kernels/temporal_attn.py:_kernel (both stages, pallas_call
// at :205) and :_kernel1 (one stage per call, :226), public op
// fused_double_self_attn.
//
// Bound on this card: bytes. Each token attends to only 16 others, so the
// attention core is 2*2*16*64 FLOP per token and head, far below the card's
// ~295 FLOP/byte balance; the projections are short-K GEMMs (K = C).
//
// Design: the TPU kernel packs 128/T sequences into a 128x128 block-diagonal
// logits tile for its 128x128 matrix unit and masks the off-diagonal blocks.
// On Hopper a warp's 16-row mma tile is exactly one sequence, so each warp
// computes only its own 16x16 diagonal block: nothing is masked and nothing
// is wasted. LN statistics, the q|k|v GEMM with the LN prologue and the
// out-projection GEMM with bias + residual are shared with kernel 1. As in the
// TPU kernel, probabilities are normalised before the P @ V product.
#include "attn.cuh"
#include "gemm.cuh"

namespace mudg {

__global__ void __launch_bounds__(128)
    attn_blockdiag16_kernel(const bf16* __restrict__ qkv,
                            bf16* __restrict__ out, int c) {
  __shared__ __align__(16) bf16 qs[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 ks[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 vt[AT_ROWS * AT_LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int h = blockIdx.y;
  const size_t row0 = (size_t)blockIdx.x * AT_ROWS;
  const int ld = 3 * c;

  load_tile64<false>(qs, qkv, row0, ld, h * 64);
  load_tile64<false>(ks, qkv, row0, ld, c + h * 64);
  load_tile64<true>(vt, qkv, row0, ld, 2 * c + h * 64);
  __syncthreads();
  uint32_t qf[4][4];
  load_q_frags(qf, qs, warp, g, q);

  float s[2][4];
  qk_logits<2>(s, qf, ks, warp * 16, g, q);
  float one[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float mx = quad_max(fmaxf(fmaxf(s[0][2 * hh], s[0][2 * hh + 1]),
                                    fmaxf(s[1][2 * hh], s[1][2 * hh + 1])));
    float sum = 0.f;
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      s[nj][2 * hh] = exp2f(s[nj][2 * hh] - mx);
      s[nj][2 * hh + 1] = exp2f(s[nj][2 * hh + 1] - mx);
      sum += s[nj][2 * hh] + s[nj][2 * hh + 1];
    }
    const float inv = 1.f / quad_sum(sum);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      s[nj][2 * hh] *= inv;
      s[nj][2 * hh + 1] *= inv;
    }
    one[hh] = 1.f;
  }
  float o[8][4];
#pragma unroll
  for (int dj = 0; dj < 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dj][e] = 0.f;
  pv_accumulate<1>(o, s, vt, warp * 16, g, q);
  store_o(out, c, row0 + warp * 16, h * 64, o, one, g, q);
}

}  // namespace mudg

using namespace mudg;

// One stage. x, out: (rows, c) bf16 with rows % 64 == 0 and sequences of 16
// consecutive rows. Scratch: qkv (rows, 3c) bf16, attn (rows, c) bf16,
// mean/rstd (rows) fp32. Weights: ln_w, ln_b, bo fp32 (c); wqkv (3c, c) bf16
// with the softmax scale folded into its first c rows; wo (c, c) bf16.
extern "C" int mudg_temporal_attn_stage(const void* x, void* out, void* qkv,
                                        void* attn, void* mean, void* rstd,
                                        const void* ln_w, const void* ln_b,
                                        const void* wqkv, const void* wo,
                                        const void* bo, int rows, int c,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_row_stats(static_cast<const bf16*>(x), rows, c, 1e-5f,
                                     static_cast<float*>(mean),
                                     static_cast<float*>(rstd), st);
  if (err != cudaSuccess) return err;

  GemmArgs p = gemm_args();
  p.a = static_cast<const bf16*>(x);
  p.lda = c;
  p.b = static_cast<const bf16*>(wqkv);
  p.ldb = c;
  p.out = static_cast<bf16*>(qkv);
  p.ldo = 3 * c;
  p.m = rows;
  p.n = 3 * c;
  p.k = c;
  p.row_mean = static_cast<const float*>(mean);
  p.row_rstd = static_cast<const float*>(rstd);
  p.ln_w = static_cast<const float*>(ln_w);
  p.ln_b = static_cast<const float*>(ln_b);
  err = launch_gemm<A_LN, E_BIAS>(p, st);
  if (err != cudaSuccess) return err;

  attn_blockdiag16_kernel<<<dim3(rows / AT_ROWS, c / 64), 128, 0, st>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  p = gemm_args();
  p.a = static_cast<const bf16*>(attn);
  p.lda = c;
  p.b = static_cast<const bf16*>(wo);
  p.ldb = c;
  p.out = static_cast<bf16*>(out);
  p.ldo = c;
  p.m = rows;
  p.n = c;
  p.k = c;
  p.bias = static_cast<const float*>(bo);
  p.res = static_cast<const bf16*>(x);
  p.ldr = c;
  return launch_gemm<A_PLAIN, E_BIAS_RES>(p, st);
}
