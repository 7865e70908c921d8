// The bf16 flash-attention forward core shared by kernel 5 (flash_attn.cu)
// and kernel 1's attention (spatial_attn.cu): non-causal attention over
// q, k, v (B, L, H, 64) bf16, each read in place through its own (batch,
// sequence, head) strides,
//   o = softmax2(qscale * q k^T) v,   lse = ln 2 * logsumexp2(qscale * q k^T),
// with o (B, L, H, 64) bf16 contiguous and, where LSE is set, lse (B*H, L)
// fp32 in natural-log units (the row statistic a FlashAttention-2 backward
// reads). q is scaled by qscale in fp32 and rounded to bf16, the softmax
// runs in base 2 in fp32, P is rounded to bf16 for P @ V, lse = m ln 2 +
// ln l: kernel 5 passes qscale = d^-0.5 * log2(e), as the TPU kernel
// scales q (flash_attention.py:29-35,61); kernel 1 passes 1, since its Wq
// already carries that factor (a bf16 value times 1.0 rounds to itself).
//
// Bound on this card: tensor-core issue at the training lengths (MDM1024
// ds1, 16 x 9216 x 5 heads: 4 * 80 * 9216^2 * 64 = 1.74 TFLOP, 1.76 ms at
// 989 TFLOP/s, against 47 MB of operands); at MDM1024 ds4 (32 x 576, 20
// heads) a call is 54.4 GFLOP (0.055 ms) against 190 MB (0.057 ms at 3.35
// TB/s), balanced between the two. The earlier design (mma.sync from 64x64
// tiles, synchronous loads, V transposed by scalar stores) reached 12% of
// the bound, so the products must come from wgmma fed by TMA.
//
// Design (FlashAttention-3 shaped): one block of three warpgroups per (128
// queries, head, batch). Warpgroup 0 is the producer: one thread loads the
// block's Q by TMA, then keeps a ring of FW_STAGES 128-key K/V tiles in
// flight (TMA, 128-byte swizzle, one full and one empty mbarrier per
// stage), and gives its registers away (setmaxnreg 24). Warpgroups 1 and 2
// each own 64 query rows (setmaxnreg 240): they scale their Q rows in shared
// memory (generic stores, then an async-proxy fence before wgmma reads
// them), then per K/V tile form S = Q K^T by wgmma m64n128k16 with both
// operands from shared memory (K-major), run the base-2 online softmax in
// fp32 registers, and accumulate O += P V by wgmma m64n64k16 with P from
// registers (the S accumulator rounded to bf16 is the A fragment) and V
// through the transpose bit: no thread transposes anything.
// At head dim 64 the exponentials alone take as long as the products at
// the tensor cores' peak (one exp2 per 256 operations: 3.9 T a second
// either way), so the softmax must run beside the products. As in
// FlashAttention-3, each warpgroup pipelines its tiles (tile t's S product
// is issued ahead of tile t-1's P V, so its softmax runs while the tensor
// cores finish that P V), and the two warpgroups take turns to issue their
// products (named barriers), so one's softmax overlaps the other's
// products. (On the H100 the pipeline alone was slower than a plain
// loop; with the turns it is faster than both.) ptxas: 168 registers a
// thread, no spills.
// Keys past L in the last tile arrive as zeros and are masked to -inf;
// query rows past L are computed on zeros and not stored (L % 128 may be
// 64: MDM1024 ds4).
// Not yet: TMA stores of O, exponentials partly on the FMA units.
#pragma once

#include "hopper.cuh"

namespace mudg {

constexpr int FW_ROWS = 128;     // query rows per block (two consumer warpgroups)
constexpr int FW_KEYS = 128;     // keys per K/V tile
constexpr int FW_STAGES = 4;     // K/V tiles in flight
constexpr int FW_TILE = 64 * 64 * 2;   // bytes of one 64-row box
constexpr int FW_SMEM = 1024 + 2 * FW_TILE + FW_STAGES * 4 * FW_TILE + 1024;

struct FlashFwdArgs {
  bf16* o;
  float* lse;    // written where LSE is set
  int seq, heads;
  float qscale;  // the factor q takes before q k^T
};

// Keys at or past `valid` (a multiple of 64) of a 128-key S tile to -inf.
__device__ __forceinline__ void mask_tail(float (&sc)[64], int valid) {
  if (valid >= FW_KEYS) return;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (8 * j >= valid) sc[4 * j] = sc[4 * j + 1] = sc[4 * j + 2] = sc[4 * j + 3] = -INFINITY;
}

// The base-2 online softmax of one S tile of N / 2 columns (N registers) in
// place (P = 2^(S - m)), for this thread's rows g and g + 8: the running max m, the row sums l (this
// thread's columns; summed over the quad at the end) and the factor alpha
// by which O must be rescaled before it takes this tile's P V.
template <bool FIRST, int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
    mx = quad_max(mx);
    const float mnew = FIRST ? mx : fmaxf(m[hh], mx);
    alpha[hh] = FIRST ? 1.f : exp2f(m[hh] - mnew);
    m[hh] = mnew;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      sc[4 * j + 2 * hh] = exp2f(sc[4 * j + 2 * hh] - mnew);
      sc[4 * j + 2 * hh + 1] = exp2f(sc[4 * j + 2 * hh + 1] - mnew);
      sum += sc[4 * j + 2 * hh] + sc[4 * j + 2 * hh + 1];
    }
    l[hh] = FIRST ? sum : l[hh] * alpha[hh] + sum;
  }
}

__device__ __forceinline__ void rescale_o(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <bool LSE>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const FlashFwdArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(sm);                       // 128 rows
  uint8_t* skv = sm + 2 * FW_TILE;                // per stage: K 128 rows, V 128 rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + FW_STAGES * 4 * FW_TILE);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + FW_STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int q0 = blockIdx.x * FW_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (p.seq + FW_KEYS - 1) / FW_KEYS;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(bar_q, 2 * FW_TILE);
      tma_load_rows(sq, &tq, bar_q, h, q0, b);
      tma_load_rows(sm + FW_TILE, &tq, bar_q, h, q0 + 64, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % FW_STAGES;
        if (t >= FW_STAGES) mbar_wait(&empty[s], ((t / FW_STAGES) - 1) & 1);
        uint8_t* st = skv + s * 4 * FW_TILE;
        const int k0 = t * FW_KEYS;
        mbar_expect_tx(&full[s], 4 * FW_TILE);
        tma_load_rows(st, &tk, &full[s], h, k0, b);
        tma_load_rows(st + FW_TILE, &tk, &full[s], h, k0 + 64, b);
        tma_load_rows(st + 2 * FW_TILE, &tv, &full[s], h, k0, b);
        tma_load_rows(st + 3 * FW_TILE, &tv, &full[s], h, k0 + 64, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  setmaxnreg_inc<240>();
  const int cw = wg - 1, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  bf16* myq = sq + cw * 64 * 64;
  mbar_wait(bar_q, 0);
  {  // q * qscale in fp32, rounded to bf16, in place (any order:
     // the swizzle permutes whole 16-byte chunks within the tile)
    uint4* qv = reinterpret_cast<uint4*>(myq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 v = qv[tid + 128 * i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack_bf16x2(w[j]);
        w[j] = pack_bf16x2(f.x * p.qscale, f.y * p.qscale);
      }
      qv[tid + 128 * i] = v;
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);
  }
  const uint64_t dq = sw128_desc(myq);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2], l[2], alpha[2];
  uint32_t pa[8][4];  // P of the previous tile, the A operand of O += P V

  // ping-pong: warpgroup cw issues its products after bar 3 + cw, then
  // lets the other go (bar 4 - cw); warpgroup 0 starts
  if (cw == 1) named_bar_arrive(3, 256);
  {  // tile 0: S, then its softmax (no earlier P V to overlap)
    mbar_wait(&full[0], 0);
    float sc[64];
    named_bar_sync(3 + cw, 256);
    wgmma_fence();
    const uint64_t dk = sw128_desc(skv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n128(sc, dq + kk * KMAJOR_K16, dk + kk * KMAJOR_K16, kk);
    wgmma_commit();
    named_bar_arrive(4 - cw, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    mask_tail(sc, p.seq);
    online_softmax<true>(sc, m, l, alpha);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) acc_to_a(pa[kk], sc, kk);
  }
  // Software pipeline (FlashAttention-3's intra-warpgroup overlap): tile t's
  // S = Q K^T is issued ahead of tile t-1's P V, so the softmax of tile t
  // runs while the tensor cores finish the previous P V; O takes tile t-1's
  // rescale just before that P V is issued.
  for (int t = 1; t < ntiles; ++t) {
    const int s = t % FW_STAGES, sp = (t - 1) % FW_STAGES;
    mbar_wait(&full[s], (t / FW_STAGES) & 1);
    float sc[64];
    fence_regs(o);
    fence_regs(pa);
    named_bar_sync(3 + cw, 256);
    wgmma_fence();
    const uint64_t dk = sw128_desc(skv + s * 4 * FW_TILE);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n128(sc, dq + kk * KMAJOR_K16, dk + kk * KMAJOR_K16, kk);
    wgmma_commit();
    rescale_o(o, alpha);
    wgmma_fence();
    const uint64_t dv = sw128_desc(skv + sp * 4 * FW_TILE + 2 * FW_TILE);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs_n64_tb(o, pa[kk], dv + kk * MNMAJOR_K16);
    wgmma_commit();
    named_bar_arrive(4 - cw, 256);
    wgmma_wait<1>();  // S of tile t is in; P_{t-1} V_{t-1} may still run
    fence_regs(sc);
    mask_tail(sc, p.seq - t * FW_KEYS);
    online_softmax<false>(sc, m, l, alpha);
    wgmma_wait<0>();  // P_{t-1} V_{t-1} done: tile t-1's stage is free
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[sp]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) acc_to_a(pa[kk], sc, kk);
  }
  {  // the last tile's P V
    const int s = (ntiles - 1) % FW_STAGES;
    fence_regs(o);
    fence_regs(pa);
    rescale_o(o, alpha);
    wgmma_fence();
    const uint64_t dv = sw128_desc(skv + s * 4 * FW_TILE + 2 * FW_TILE);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs_n64_tb(o, pa[kk], dv + kk * MNMAJOR_K16);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);   // wgmma reads its register A operand until the wait
    mbar_arrive(&empty[s]);
  }
  if (cw == 0) named_bar_sync(3, 256);  // warpgroup 1's last arrival

  const float sum[2] = {quad_sum(l[0]), quad_sum(l[1])};
  const int row0 = q0 + cw * 64 + warp * 16 + g;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= p.seq) continue;
    const float inv = 1.f / sum[hh];
    bf16* orow = p.o + (((size_t)b * p.seq + r) * p.heads + h) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * qd) =
          pack_bf16x2(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    if (LSE && qd == 0)
      p.lse[((size_t)b * p.heads + h) * p.seq + r] = m[hh] * 0.6931471805599453f + logf(sum[hh]);
  }
}

// Launches the core on `stream`. q, k, v: (batch, seq, heads, 64) bf16 with
// the given element strides (the head dim contiguous, every stride a
// multiple of 8, 16-byte aligned pointers); o: (batch, seq, heads, 64) bf16
// contiguous; lse: (batch*heads, seq) fp32, written where LSE is set.
// seq % 64 == 0 (the last 128-row block may be half empty).
template <bool LSE>
static inline cudaError_t launch_flash_fwd(const bf16* q, long long q_sb, long long q_sl,
                                           long long q_sh, const bf16* k, long long k_sb,
                                           long long k_sl, long long k_sh, const bf16* v,
                                           long long v_sb, long long v_sl, long long v_sh,
                                           bf16* o, float* lse, int batch, int seq, int heads,
                                           float qscale, cudaStream_t stream) {
  // The dynamic shared-memory limit is raised once per host thread: a
  // launch from a thread that has not raised it (autograd's device thread)
  // was refused with "invalid argument".
  thread_local bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, FW_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  using mudg_host::bf16_rows_map;
  CUtensorMap tq, tk, tv;
  cudaError_t e = bf16_rows_map(&tq, q, batch, seq, heads, q_sb, q_sl, q_sh);
  if (e == cudaSuccess) e = bf16_rows_map(&tk, k, batch, seq, heads, k_sb, k_sl, k_sh);
  if (e == cudaSuccess) e = bf16_rows_map(&tv, v, batch, seq, heads, v_sb, v_sl, v_sh);
  if (e != cudaSuccess) return e;
  FlashFwdArgs p;
  p.o = o;
  p.lse = lse;
  p.seq = seq;
  p.heads = heads;
  p.qscale = qscale;
  const dim3 grid((seq + FW_ROWS - 1) / FW_ROWS, heads, batch);
  flash_fwd_kernel<LSE><<<grid, 384, FW_SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace mudg
