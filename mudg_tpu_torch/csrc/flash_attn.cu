// Kernel 5: non-causal scaled dot-product attention and its logsumexp,
//   o = softmax(q k^T / 8) v,   lse = logsumexp(q k^T / 8)   (head dim 64),
// over q, k, v (B, L, H, 64) bf16, each read in place through its own
// (batch, sequence, head) strides; o (B, L, H, 64) bf16 contiguous, lse
// (B*H, L) fp32 in natural-log units, the row statistic a FlashAttention-2
// backward reads. The fp32 kernel is in flash_attn_f32.cu.
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
// The kernel itself, its bound and its design are in flash_fwd.cuh, shared
// with kernel 1's attention core.
#include "flash_fwd.cuh"

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
  return launch_flash_fwd<true>(
      static_cast<const bf16*>(q), q_sb, q_sl, q_sh, static_cast<const bf16*>(k), k_sb, k_sl,
      k_sh, static_cast<const bf16*>(v), v_sb, v_sl, v_sh, static_cast<bf16*>(o),
      static_cast<float*>(lse), batch, seq, heads, 0.125f * 1.4426950408889634f,
      static_cast<cudaStream_t>(stream));
}
