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
// Offsets: every element offset is formed in size_t (rows * ld in the GEMM
// loads and stores, the row stats and the attention tiles); the int values
// are row counts and grid indices. At a 3-task, 3-variant MDM1024 batch
// (144 frames of 9216 tokens) the q|k|v scratch holds 1.27e9 elements, under
// 2^31 but not by much, and rows = 1.33e6 stays far inside int.
//
// Design: four launches instead of the TPU's one, because one SM cannot hold a
// whole 2560-token K/V the way VMEM can.
//   1. per-row LN statistics (fp32, two-pass);
//   2. one GEMM for q|k|v (N = 3C) with the LN applied in its A prologue, so
//      the normalised x never goes to device memory; Wq carries the folded
//      d^-0.5*log2(e) as in the TPU kernel;
//   3. a flash-style core: one block per (64 queries, head, sequence), K/V
//      streamed through shared memory in 64-key tiles, online base-2 softmax
//      in fp32 registers, P @ V from the logits' registers;
//   4. the out-projection GEMM with bias and the residual in its epilogue.
// q|k|v and the attention output make one round trip through device memory;
// keeping them on chip (wgmma, TMA, one persistent kernel) is later work.
#include "attn.cuh"
#include "gemm.cuh"

namespace mudg {

__global__ void __launch_bounds__(128)
    attn_dense_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                      int seq, int c) {
  __shared__ __align__(16) bf16 qs[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 ks[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 vt[AT_ROWS * AT_LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int h = blockIdx.y;
  const size_t base = (size_t)blockIdx.z * seq;
  const int ld = 3 * c;

  load_tile64<false>(qs, qkv, base + blockIdx.x * AT_ROWS, ld, h * 64);
  __syncthreads();
  uint32_t qf[4][4];
  load_q_frags(qf, qs, warp, g, q);

  float o[8][4];
#pragma unroll
  for (int dj = 0; dj < 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dj][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < seq; kb += AT_ROWS) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile64<false>(ks, qkv, base + kb, ld, c + h * 64);
    load_tile64<true>(vt, qkv, base + kb, ld, 2 * c + h * 64);
    __syncthreads();
    float s[8][4];
    qk_logits<8>(s, qf, ks, 0, g, q);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
        mx = fmaxf(mx, fmaxf(s[nj][2 * hh], s[nj][2 * hh + 1]));
      const float mnew = fmaxf(m[hh], quad_max(mx));
      const float alpha = exp2f(m[hh] - mnew);
      m[hh] = mnew;
      l[hh] *= alpha;
#pragma unroll
      for (int dj = 0; dj < 8; ++dj) {
        o[dj][2 * hh] *= alpha;
        o[dj][2 * hh + 1] *= alpha;
      }
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        s[nj][2 * hh] = exp2f(s[nj][2 * hh] - mnew);
        s[nj][2 * hh + 1] = exp2f(s[nj][2 * hh + 1] - mnew);
        l[hh] += s[nj][2 * hh] + s[nj][2 * hh + 1];
      }
    }
    pv_accumulate<4>(o, s, vt, 0, g, q);
  }
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  store_o(out, c, base + blockIdx.x * AT_ROWS + warp * 16, h * 64, o, inv, g, q);
}

}  // namespace mudg

using namespace mudg;

// x, out: (batch*seq, c) bf16. Scratch: qkv (batch*seq, 3c) bf16,
// attn (batch*seq, c) bf16, mean/rstd (batch*seq) fp32. Weights: ln_w, ln_b,
// bo fp32 (c); wqkv (3c, c) bf16 with the softmax scale folded into its first
// c rows; wo (c, c) bf16. seq % 64 == 0, c % 64 == 0.
extern "C" int mudg_spatial_attn(const void* x, void* out, void* qkv, void* attn,
                                 void* mean, void* rstd, const void* ln_w,
                                 const void* ln_b, const void* wqkv,
                                 const void* wo, const void* bo, int batch,
                                 int seq, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = batch * seq;
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

  attn_dense_kernel<<<dim3(seq / AT_ROWS, c / 64, batch), 128, 0, st>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), seq, c);
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

extern "C" const char* mudg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
