// Kernel 5: non-causal scaled dot-product attention and its logsumexp,
//   o = softmax(q k^T / 8) v,   lse = logsumexp(q k^T / 8)   (head dim 64),
// over q, k, v (B, L, H, 64) bf16, each read in place through its own
// (batch, sequence, head) strides; o (B, L, H, 64) bf16 contiguous, lse
// (B*H, L) fp32 in natural-log units, the row statistic a FlashAttention-2
// backward reads.
//
// Replaces: mudg_tpu/kernels/flash_attention.py:_oneshot_kernel and
// _fwd_kernel (flash_attention, pallas_call at :132 and :159). The TPU keeps
// two bodies, a whole-KV softmax when K/V fit VMEM and an online-softmax
// loop otherwise; both compute this function, and one online-softmax kernel
// covers both here: an SM cannot hold a whole K/V at any length the TPU's
// oneshot admits (576 x 64 x 2 x 2 B per head is fine, 9216 is not).
// Numerics as the TPU kernel (flash_attention.py:29-35,61): q is scaled by
// d^-0.5 * log2(e) in fp32 and rounded to bf16, the softmax runs in base 2
// in fp32, P is rounded to bf16 for P @ V, lse = m ln 2 + ln l.
//
// Bound on this card: at MDM1024 ds4 (32 x 576, 20 heads) a call is
// 4 * 640 * 576^2 * 64 = 54.4 GFLOP (0.055 ms at 989 TFLOP/s) against 190 MB
// of q/k/v/o/lse (0.057 ms at 3.35 TB/s), balanced between the two; at
// L = 9216 the tensor-core products dominate by far.
//
// Design: the flash core of kernel 1 (attn.cuh) with its loads generalised
// to strided (B, L, H, 64) operands: one block of 4 warps per (64 queries,
// head, batch), each warp owning 16 query rows whose q fragments stay in
// registers; K/V stream through shared memory in 64-key tiles (V stored
// transposed), logits and the output accumulate in fp32 registers through
// mma.sync m16n8k16. No fold/unfold copy of q/k/v (the TPU wrapper's
// transposes, flash_attention.py:459-469) and no (L, L) matrix in memory.
// Not yet: cp.async double-buffering of the K/V tiles, wgmma, TMA.
#include "attn.cuh"

namespace mudg {

struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  long long q_sb, q_sl, q_sh;  // element strides over batch, sequence, head
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  int seq, heads;
  float qscale;  // d^-0.5 * log2(e)
};

// Copy 64 rows x 64 columns (row stride ld elements, columns contiguous)
// into shared memory, row-major or transposed; SCALE multiplies every value
// by `scale` in fp32 and rounds back to bf16.
template <bool TRANSPOSE, bool SCALE>
__device__ __forceinline__ void fa_load_tile(bf16* dst, const bf16* src,
                                             long long ld, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + i * 128, r = c >> 3, col = (c & 7) * 8;
    uint4 v = *reinterpret_cast<const uint4*>(src + r * ld + col);
    if (SCALE) {
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack_bf16x2(w[j]);
        w[j] = pack_bf16x2(f.x * scale, f.y * scale);
      }
    }
    if (TRANSPOSE) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(col + j) * AT_LDS + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * AT_LDS + col) = v;
    }
  }
}

__global__ void __launch_bounds__(128) flash_fwd_kernel(const FlashArgs p) {
  __shared__ __align__(16) bf16 qs[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 ks[AT_ROWS * AT_LDS];
  __shared__ __align__(16) bf16 vt[AT_ROWS * AT_LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int q0 = blockIdx.x * AT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;

  fa_load_tile<false, true>(qs, qb + q0 * p.q_sl, p.q_sl, p.qscale);
  __syncthreads();
  uint32_t qf[4][4];
  load_q_frags(qf, qs, warp, g, q);

  float o[8][4];
#pragma unroll
  for (int dj = 0; dj < 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dj][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < p.seq; k0 += AT_ROWS) {
    __syncthreads();  // every warp is done with the previous K/V tile
    fa_load_tile<false, false>(ks, kb + k0 * p.k_sl, p.k_sl, 1.f);
    fa_load_tile<true, false>(vt, vb + k0 * p.v_sl, p.v_sl, 1.f);
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
  const float sum[2] = {quad_sum(l[0]), quad_sum(l[1])};
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
  const int row0 = q0 + warp * 16;
  store_o(p.o + ((size_t)b * p.seq * p.heads + h) * 64, p.heads * 64, row0, 0, o,
          inv, g, q);
  if (q == 0) {
    float* lrow = p.lse + ((size_t)b * p.heads + h) * p.seq + row0 + g;
    lrow[0] = m[0] * 0.6931471805599453f + logf(sum[0]);
    lrow[8] = m[1] * 0.6931471805599453f + logf(sum[1]);
  }
}

}  // namespace mudg

using namespace mudg;

// q, k, v: (batch, seq, heads, 64) bf16 with the given element strides (the
// head dim contiguous, every stride a multiple of 8, 16-byte aligned
// pointers); o: (batch, seq, heads, 64) bf16 contiguous; lse: (batch*heads,
// seq) fp32. seq % 64 == 0.
extern "C" int mudg_flash_attn(const void* q, const void* k, const void* v, void* o,
                               void* lse, int batch, int seq, int heads,
                               long long q_sb, long long q_sl, long long q_sh,
                               long long k_sb, long long k_sl, long long k_sh,
                               long long v_sb, long long v_sl, long long v_sh,
                               void* stream) {
  FlashArgs p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
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
  p.qscale = 0.125f * 1.4426950408889634f;
  flash_fwd_kernel<<<dim3(seq / AT_ROWS, heads, batch), 128, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
