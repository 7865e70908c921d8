// Kernel 6: the FlashAttention-2 backward of kernel 5,
//   P = exp(q k^T / 8 - lse),  dP = dO v^T,  dS = P * (dP - delta),
//   dq = dS k / 8,  dk = dS^T q / 8,  dv = P^T dO   (head dim 64),
// with delta = rowsum(o * dO) computed outside (a torch op, as it is XLA
// outside the kernels on the TPU). q, k, v (B, L, H, 64) bf16 read in place
// through their own (batch, sequence, head) strides; dO (B, L, H, 64) and
// dq, dk, dv (B, L, H, 64) bf16 contiguous; lse and delta (B*H, L) fp32.
//
// Replaces: mudg_tpu/kernels/flash_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (pallas_call at :396 and :412) and their long-L bodies
// _bwd_dq_kernel_chunked and _bwd_dkv_kernel_chunked (:315, :331), which the
// TPU needs when whole-L K/V blocks overflow VMEM; all four compute this
// function, and both kernels here stream 64-row tiles at any L % 64 == 0, so
// MDM1024's L = 9216 needs no second variant.
// Numerics as the TPU kernels (flash_attention.py:181-242): q scaled by
// d^-0.5 * log2(e) in fp32 and rounded to bf16 for the logits, P in base 2
// from lse * log2(e) in fp32, dS rounded to bf16 for its products, P rounded
// to bf16 for dv, dk from the unscaled q, fp32 accumulators throughout.
//
// Bound on this card: tensor-core issue. The function needs five L x L x 64
// products per (batch, head) (re-form S, dP, then dq, dk, dv): at MDM1024 ds1
// (16 x 9216 x 5 heads) 10 * 80 * 9216^2 * 64 = 4.3 TFLOP over ~47 MB of
// operands. These two kernels do seven (S and dP are formed in both).
//
// Design: two kernels, no atomics, so every gradient is written once by one
// block and the result is deterministic:
//   dq:   one block of 4 warps per (64 queries, head, batch); each warp keeps
//         its 16 rows of q and dO as mma fragments in registers and walks the
//         K/V tiles (K row-major for the logits and transposed for dS k, V
//         row-major for dP), accumulating dq in fp32 registers;
//   dk/dv: one block per (64 keys, head, batch); each warp keeps its 16 rows
//         of k and v as fragments and walks the Q/dO tiles, forming P^T and
//         dS^T directly as k q^T and v dO^T (so no fragment is transposed),
//         with q and dO transposed in shared memory for the dv and dk
//         products.
// Not yet: cp.async double-buffering of the tiles, wgmma, TMA.
#include "attn.cuh"

namespace mudg {

constexpr float FA_LOG2E = 1.4426950408889634f;

struct FlashBwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long q_sb, q_sl, q_sh;  // element strides over batch, sequence, head
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  int seq, heads;
  float qscale;  // d^-0.5 * log2(e)
  float scale;   // d^-0.5
};

__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(const FlashBwdArgs p) {
  __shared__ __align__(16) bf16 ks[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 kt[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 vs[AT_ROWS * AT_LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int q0 = blockIdx.x * AT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const long long ld_o = (long long)p.heads * 64;
  const size_t obase = ((size_t)b * p.seq * p.heads + h) * 64;

  // q (scaled) and dO rows of this block, staged through ks and vs
  fa_load_tile<false, true>(ks, qb + q0 * p.q_sl, p.q_sl, p.qscale);
  fa_load_tile<false, false>(vs, p.dout + obase + q0 * ld_o, ld_o, 1.f);
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];
  load_q_frags(qf, ks, warp, g, q);
  load_q_frags(dof, vs, warp, g, q);
  const int row0 = q0 + warp * 16;
  const size_t srow = ((size_t)b * p.heads + h) * p.seq + row0;
  const float lse2[2] = {p.lse[srow + g] * FA_LOG2E, p.lse[srow + g + 8] * FA_LOG2E};
  const float dl[2] = {p.delta[srow + g], p.delta[srow + g + 8]};

  float dq[8][4];
#pragma unroll
  for (int dj = 0; dj < 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dj][e] = 0.f;

  for (int k0 = 0; k0 < p.seq; k0 += AT_ROWS) {
    __syncthreads();  // every warp is done with the previous tiles
    fa_load_tile<false, false>(ks, kb + k0 * p.k_sl, p.k_sl, 1.f);
    fa_load_tile<true, false>(kt, kb + k0 * p.k_sl, p.k_sl, 1.f);
    fa_load_tile<false, false>(vs, vb + k0 * p.v_sl, p.v_sl, 1.f);
    __syncthreads();
    float s[8][4], dp[8][4];
    qk_logits<8>(s, qf, ks, 0, g, q);
    qk_logits<8>(dp, dof, vs, 0, g, q);
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        s[nj][e] = exp2f(s[nj][e] - lse2[hh]) * (dp[nj][e] - dl[hh]);
      }
    pv_accumulate<4>(dq, s, kt, 0, g, q);   // dq += dS @ K
  }
  const float sc[2] = {p.scale, p.scale};
  store_o(p.dq + obase, (int)ld_o, row0, 0, dq, sc, g, q);
}

__global__ void __launch_bounds__(128) flash_bwd_dkv_kernel(const FlashBwdArgs p) {
  __shared__ __align__(16) bf16 qs[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 qt[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 dos[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 dot[AT_ROWS * AT_LDS];
  __shared__ float lse_s[AT_ROWS], dl_s[AT_ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int k0 = blockIdx.x * AT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const long long ld_o = (long long)p.heads * 64;
  const size_t obase = ((size_t)b * p.seq * p.heads + h) * 64;
  const size_t sbase = ((size_t)b * p.heads + h) * p.seq;

  // k and v rows of this block as fragments, staged through qs and dos
  fa_load_tile<false, false>(qs, kb + k0 * p.k_sl, p.k_sl, 1.f);
  fa_load_tile<false, false>(dos, vb + k0 * p.v_sl, p.v_sl, 1.f);
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  load_q_frags(kf, qs, warp, g, q);
  load_q_frags(vf, dos, warp, g, q);

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int dj = 0; dj < 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dj][e] = dv[dj][e] = 0.f;

  for (int q0 = 0; q0 < p.seq; q0 += AT_ROWS) {
    __syncthreads();
    fa_load_tile<false, true>(qs, qb + q0 * p.q_sl, p.q_sl, p.qscale);
    fa_load_tile<true, false>(qt, qb + q0 * p.q_sl, p.q_sl, 1.f);
    fa_load_tile<false, false>(dos, p.dout + obase + q0 * ld_o, ld_o, 1.f);
    fa_load_tile<true, false>(dot, p.dout + obase + q0 * ld_o, ld_o, 1.f);
    if (threadIdx.x < AT_ROWS) {
      lse_s[threadIdx.x] = p.lse[sbase + q0 + threadIdx.x] * FA_LOG2E;
      dl_s[threadIdx.x] = p.delta[sbase + q0 + threadIdx.x];
    }
    __syncthreads();
    // P^T and dP^T: rows are this warp's keys, columns the 64 queries
    float st[8][4], dpt[8][4];
    qk_logits<8>(st, kf, qs, 0, g, q);
    qk_logits<8>(dpt, vf, dos, 0, g, q);
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nj * 8 + 2 * q + (e & 1);
        st[nj][e] = exp2f(st[nj][e] - lse_s[col]);
        dpt[nj][e] = st[nj][e] * (dpt[nj][e] - dl_s[col]);
      }
    pv_accumulate<4>(dv, st, dot, 0, g, q);   // dv += P^T @ dO
    pv_accumulate<4>(dk, dpt, qt, 0, g, q);   // dk += dS^T @ q
  }
  const int row0 = k0 + warp * 16;
  const float sc[2] = {p.scale, p.scale}, one[2] = {1.f, 1.f};
  store_o(p.dk + obase, (int)ld_o, row0, 0, dk, sc, g, q);
  store_o(p.dv + obase, (int)ld_o, row0, 0, dv, one, g, q);
}

}  // namespace mudg

using namespace mudg;

// q, k, v: (batch, seq, heads, 64) bf16 with the given element strides (head
// dim contiguous, every stride a multiple of 8, 16-byte aligned pointers);
// dout, dq, dk, dv: (batch, seq, heads, 64) bf16 contiguous; lse, delta:
// (batch*heads, seq) fp32. seq % 64 == 0.
extern "C" int mudg_flash_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int batch, int seq,
                                   int heads, long long q_sb, long long q_sl, long long q_sh,
                                   long long k_sb, long long k_sl, long long k_sh,
                                   long long v_sb, long long v_sl, long long v_sh,
                                   void* stream) {
  FlashBwdArgs p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_sb = q_sb;
  p.q_sl = q_sl;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_sl = k_sl;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_sl = v_sl;
  p.v_sh = v_sh;
  p.seq = seq;
  p.heads = heads;
  p.scale = 0.125f;
  p.qscale = 0.125f * FA_LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(seq / AT_ROWS, heads, batch);
  flash_bwd_dq_kernel<<<grid, 128, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<<<grid, 128, 0, st>>>(p);
  return cudaGetLastError();
}
