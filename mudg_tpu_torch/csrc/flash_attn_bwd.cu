// Kernel 6: the FlashAttention-2 backward of kernel 5,
//   P = exp(q k^T / 8 - lse),  dP = dO v^T,  dS = P * (dP - delta),
//   dq = dS k / 8,  dk = dS^T q / 8,  dv = P^T dO   (head dim 64),
// with delta = rowsum(o * dO) (XLA outside the kernels on the TPU; here a
// pass before them, which also writes the scaled q). q, k, v (B, L, H, 64) bf16 read in place
// through their own (batch, sequence, head) strides; dO (B, L, H, 64) and
// dq, dk, dv (B, L, H, 64) bf16 contiguous; lse and delta (B*H, L) fp32.
// The fp32 kernels are in flash_attn_f32.cu.
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
// (16 x 9216 x 5 heads) 10 * 80 * 9216^2 * 64 = 4.3 TFLOP (4.40 ms at 989
// TFLOP/s) over ~47 MB of operands. This two-kernel design does seven (S and
// dP are formed in both), so its own bound is 7/5 of the function's. The
// earlier design (mma.sync from 64x64 tiles, synchronous loads, q and dO
// transposed in shared memory by scalar stores) reached 10% of it.
//
// Design: two warp-specialised kernels of three warpgroups, no atomics, so
// every gradient element is written once by one block and reruns agree bit
// for bit. Warpgroup 0 is the producer (setmaxnreg 24): one thread loads the
// block's resident rows by TMA, then keeps a ring of BW_STAGES streamed
// 64-row tiles in flight (TMA, 128-byte swizzle, a full and an empty
// mbarrier per stage). Warpgroups 1 and 2 (setmaxnreg 240) each own 64 of
// the block's 128 resident rows and run every product on wgmma:
//   dk/dv: one block per (128 keys, head, batch); K and V resident; per
//          stage the tile of 64 queries' scaled q, q and dO, with their lse
//          and delta rows (bulk copies). S^T = K q_s^T and dP^T = V dO^T
//          (m64n64k16, both operands K-major in shared memory), P^T and dS^T
//          in fp32 registers, then dV += P^T dO and dK += dS^T q with A from
//          registers (the accumulators rounded to bf16) and B through the
//          transpose bit;
//   dq:    one block per (128 queries, head, batch); scaled q and dO
//          resident; per stage a 64-key tile of K and V. S = q_s K^T and
//          dP = dO V^T from shared memory, dS in registers, dQ += dS K with
//          K through the transpose bit.
// The scaled, bf16-rounded q (q_s) and delta are written once by a small
// pass before both kernels, so neither transposes nor rescales a tile. Rows past L of a
// block's resident tile arrive as zeros from TMA and are not stored.
// The dq kernel's warpgroups pipeline their tiles: tile t's S and dP
// products are issued ahead of tile t-1's dQ product, so the elementwise
// algebra of one tile runs while the tensor cores finish the other's. The
// dk/dv kernel does not (see its loop). ptxas: 168 registers a thread (the
// most a 384-thread block allows), no spills.
// Not yet: one kernel for all three gradients (it needs an ordered
// accumulation of dQ to stay deterministic), 128-row streamed tiles.
#include "hopper.cuh"

namespace mudg {

constexpr float FA_LOG2E = 1.4426950408889634f;
constexpr int BW_ROWS = 128;            // resident rows per block (two consumer warpgroups)
constexpr int BW_TILE = 64 * 64 * 2;    // bytes of one 64-row box
constexpr int BW_STAGES = 4;
// dk/dv: K, V resident; per stage q_s, q, dO (64 rows) + lse, delta (64 fp32)
constexpr int DKV_STAGE = 3 * BW_TILE + 1024;
constexpr int DKV_SMEM = 1024 + 4 * BW_TILE + BW_STAGES * DKV_STAGE + 1024;
// dq: q_s, dO resident; per stage K, V (64 rows)
constexpr int DQ_STAGE = 2 * BW_TILE;
constexpr int DQ_SMEM = 1024 + 4 * BW_TILE + BW_STAGES * DQ_STAGE + 1024;

struct FlashBwdArgs {
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int seq, heads;
  float scale;   // d^-0.5
};

// The pass before both kernels, eight threads per (b, l, h) row: q_s =
// bf16(q * d^-0.5 * log2(e)) into a contiguous (B, L, H, 64) buffer, and
// delta = rowsum(o * dO) in fp32 into (B*H, L).
__global__ void __launch_bounds__(256) prep_kernel(const bf16* __restrict__ q,
                                                   const bf16* __restrict__ o,
                                                   const bf16* __restrict__ dout,
                                                   bf16* __restrict__ qs, float* __restrict__ delta,
                                                   int seq, int heads, long long sb, long long sl,
                                                   long long sh, float qscale, long long chunks) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= chunks) return;  // chunks % 8 == 0: a row's eight threads stay together
  const int col = (int)(c & 7) * 8;
  const long long row = c >> 3;  // (b, l, h) row of the contiguous tensors
  const int h = (int)(row % heads);
  const long long bl = row / heads;
  const int l = (int)(bl % seq);
  const long long b = bl / seq;
  uint4 v = *reinterpret_cast<const uint4*>(q + b * sb + l * sl + h * sh + col);
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
  const uint4 ov = *reinterpret_cast<const uint4*>(o + row * 64 + col);
  const uint4 dv = *reinterpret_cast<const uint4*>(dout + row * 64 + col);
  const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ov);
  const uint32_t* dw = reinterpret_cast<const uint32_t*>(&dv);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = unpack_bf16x2(w[j]);
    w[j] = pack_bf16x2(f.x * qscale, f.y * qscale);
    const float2 a = unpack_bf16x2(ow[j]), d = unpack_bf16x2(dw[j]);
    acc = fmaf(a.x, d.x, fmaf(a.y, d.y, acc));
  }
  *reinterpret_cast<uint4*>(qs + row * 64 + col) = v;
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (col == 0) delta[(b * heads + h) * seq + l] = acc;
}

// Store this thread's rows of a 64 x 64 fp32 accumulator (scaled) to a
// contiguous (B, L, H, 64) bf16 tensor, rows past seq skipped.
__device__ __forceinline__ void store_rows64(bf16* out, const float (&d)[32], float scale,
                                             int row0, int seq, int heads, int h, int b,
                                             int qd) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= seq) continue;
    bf16* orow = out + (((size_t)b * seq + r) * heads + h) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * qd) =
          pack_bf16x2(d[4 * j + 2 * hh] * scale, d[4 * j + 2 * hh + 1] * scale);
  }
}

__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tqs,
                         const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const FlashBwdArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* sk = sm;                    // 128 key rows
  uint8_t* sv = sm + 2 * BW_TILE;      // 128 key rows
  uint8_t* stages = sm + 4 * BW_TILE;  // per stage: q_s, q, dO tiles, lse, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + BW_STAGES * DKV_STAGE);
  uint64_t* bar_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + BW_STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int k0 = blockIdx.x * BW_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = p.seq / 64;
  const size_t srow = ((size_t)b * p.heads + h) * p.seq;  // this (b, h)'s lse / delta row

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(bar_kv, 4 * BW_TILE);
      tma_load_rows(sk, &tk, bar_kv, h, k0, b);
      tma_load_rows(sk + BW_TILE, &tk, bar_kv, h, k0 + 64, b);
      tma_load_rows(sv, &tv, bar_kv, h, k0, b);
      tma_load_rows(sv + BW_TILE, &tv, bar_kv, h, k0 + 64, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % BW_STAGES;
        if (t >= BW_STAGES) mbar_wait(&empty[s], ((t / BW_STAGES) - 1) & 1);
        uint8_t* st = stages + s * DKV_STAGE;
        const int q0 = t * 64;
        mbar_expect_tx(&full[s], 3 * BW_TILE + 512);
        tma_load_rows(st, &tqs, &full[s], h, q0, b);
        tma_load_rows(st + BW_TILE, &tq, &full[s], h, q0, b);
        tma_load_rows(st + 2 * BW_TILE, &tdo, &full[s], h, q0, b);
        bulk_load(st + 3 * BW_TILE, p.lse + srow + q0, 256, &full[s]);
        bulk_load(st + 3 * BW_TILE + 256, p.delta + srow + q0, 256, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns key rows k0 + 64 cw .. + 63
  setmaxnreg_inc<240>();
  const int cw = wg - 1, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const uint64_t dk_res = sw128_desc(sk + cw * BW_TILE);
  const uint64_t dv_res = sw128_desc(sv + cw * BW_TILE);
  float dv[32], dk[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv[i] = dk[i] = 0.f;
  mbar_wait(bar_kv, 0);

  // Not software-pipelined: holding the next tile's S^T and dP^T beside the
  // four accumulators and the A fragments spilled past the 168 registers
  // ptxas allots a thread of this 384-thread block (the consumers' 240 from
  // setmaxnreg do not enter its allocation), and in a 288-thread block
  // (224 registers) ptxas serialised the wgmma for want of registers; both
  // ran slower than this loop on the H100. The two consumer warpgroups
  // overlap each other's algebra with their products.
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % BW_STAGES;
    uint8_t* st = stages + s * DKV_STAGE;
    mbar_wait(&full[s], (t / BW_STAGES) & 1);
    const uint64_t d_qs = sw128_desc(st), d_q = sw128_desc(st + BW_TILE);
    const uint64_t d_do = sw128_desc(st + 2 * BW_TILE);
    float sT[32], dpT[32];  // rows: this warpgroup's keys; columns: the tile's 64 queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(sT, dk_res + kk * KMAJOR_K16, d_qs + kk * KMAJOR_K16, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(dpT, dv_res + kk * KMAJOR_K16, d_do + kk * KMAJOR_K16, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
    const float* lse_s = reinterpret_cast<const float*>(st + 3 * BW_TILE);
    const float* dl_s = lse_s + 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * qd + (e & 1);
        const float pt = exp2f(sT[4 * j + e] - lse_s[col] * FA_LOG2E);
        sT[4 * j + e] = pt;
        dpT[4 * j + e] = pt * (dpT[4 * j + e] - dl_s[col]);
      }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(pa[kk], sT, kk);
      acc_to_a(da[kk], dpT, kk);
    }
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(dv, pa[kk], d_do + kk * MNMAJOR_K16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(dk, da[kk], d_q + kk * MNMAJOR_K16);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);   // wgmma reads its register A operands until the wait
    fence_regs(da);
    mbar_arrive(&empty[s]);
  }
  const int row0 = k0 + cw * 64 + warp * 16 + g;
  store_rows64(p.dk, dk, p.scale, row0, p.seq, p.heads, h, b, qd);
  store_rows64(p.dv, dv, 1.f, row0, p.seq, p.heads, h, b, qd);
}

__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tqs,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const FlashBwdArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* sqs = sm;                   // 128 query rows
  uint8_t* sdo = sm + 2 * BW_TILE;     // 128 query rows
  uint8_t* stages = sm + 4 * BW_TILE;  // per stage: K, V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + BW_STAGES * DQ_STAGE);
  uint64_t* bar_res = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + BW_STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int q0 = blockIdx.x * BW_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = p.seq / 64;

  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(bar_res, 4 * BW_TILE);
      tma_load_rows(sqs, &tqs, bar_res, h, q0, b);
      tma_load_rows(sqs + BW_TILE, &tqs, bar_res, h, q0 + 64, b);
      tma_load_rows(sdo, &tdo, bar_res, h, q0, b);
      tma_load_rows(sdo + BW_TILE, &tdo, bar_res, h, q0 + 64, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % BW_STAGES;
        if (t >= BW_STAGES) mbar_wait(&empty[s], ((t / BW_STAGES) - 1) & 1);
        uint8_t* st = stages + s * DQ_STAGE;
        mbar_expect_tx(&full[s], 2 * BW_TILE);
        tma_load_rows(st, &tk, &full[s], h, t * 64, b);
        tma_load_rows(st + BW_TILE, &tv, &full[s], h, t * 64, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  setmaxnreg_inc<240>();
  const int cw = wg - 1, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = q0 + cw * 64 + warp * 16 + g;
  const size_t srow = ((size_t)b * p.heads + h) * p.seq;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    lse2[hh] = r < p.seq ? p.lse[srow + r] * FA_LOG2E : 0.f;
    dl[hh] = r < p.seq ? p.delta[srow + r] : 0.f;
  }
  const uint64_t dqs_res = sw128_desc(sqs + cw * BW_TILE);
  const uint64_t ddo_res = sw128_desc(sdo + cw * BW_TILE);
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  uint32_t da[4][4];  // dS of the previous tile
  mbar_wait(bar_res, 0);

  // dS of tile t (S and dP from its K, V stage) into da
  auto ds_tile = [&](int t, bool overlap) {
    const int s = t % BW_STAGES;
    uint8_t* st = stages + s * DQ_STAGE;
    mbar_wait(&full[s], (t / BW_STAGES) & 1);
    const uint64_t d_k = sw128_desc(st), d_v = sw128_desc(st + BW_TILE);
    float sc[32], dp[32];  // rows: this warpgroup's queries; columns: the tile's 64 keys
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(sc, dqs_res + kk * KMAJOR_K16, d_k + kk * KMAJOR_K16, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(dp, ddo_res + kk * KMAJOR_K16, d_v + kk * KMAJOR_K16, kk);
    wgmma_commit();
    if (overlap) {  // tile t-1's dQ product behind them
      const uint64_t p_k = sw128_desc(stages + ((t - 1) % BW_STAGES) * DQ_STAGE);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(dq, da[kk], p_k + kk * MNMAJOR_K16);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      sc[i] = exp2f(sc[i] - lse2[hh]) * (dp[i] - dl[hh]);
    }
    if (overlap) {
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      mbar_arrive(&empty[(t - 1) % BW_STAGES]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], sc, kk);
  };
  // Software pipeline as FlashAttention-3's forward: tile t's S and dP are
  // issued ahead of tile t-1's dQ product.
  ds_tile(0, false);
  for (int t = 1; t < ntiles; ++t) ds_tile(t, true);
  {  // the last tile's dQ product
    const int s = (ntiles - 1) % BW_STAGES;
    const uint64_t p_k = sw128_desc(stages + s * DQ_STAGE);
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(dq, da[kk], p_k + kk * MNMAJOR_K16);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);   // wgmma reads its register A operand until the wait
    mbar_arrive(&empty[s]);
  }
  store_rows64(p.dq, dq, p.scale, row0, p.seq, p.heads, h, b, qd);
}

template <class K>
static cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace mudg

using namespace mudg;

// q, k, v: (batch, seq, heads, 64) bf16 with the given element strides (head
// dim contiguous, every stride a multiple of 8, 16-byte aligned pointers);
// o (the forward's output), dout, dq, dk, dv, qs (scratch for the scaled q):
// (batch, seq, heads, 64) bf16 contiguous; lse and delta (scratch for
// rowsum(o * dO)): (batch*heads, seq) fp32. seq % 64 == 0.
extern "C" int mudg_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, void* qs, int batch, int seq,
                                   int heads, long long q_sb, long long q_sl, long long q_sh,
                                   long long k_sb, long long k_sl, long long k_sh,
                                   long long v_sb, long long v_sl, long long v_sh,
                                   void* stream) {
  // The dynamic shared-memory limit is raised once per host thread: a
  // launch from a thread that has not raised it (autograd's device thread)
  // was refused with "invalid argument".
  thread_local bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(flash_bwd_dkv_kernel, DKV_SMEM);
    if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_kernel, DQ_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long c_sl = (long long)heads * 64, c_sb = c_sl * seq;  // contiguous strides
  using mudg_host::bf16_rows_map;
  CUtensorMap tqs, tq, tdo, tk, tv;
  cudaError_t e = bf16_rows_map(&tqs, qs, batch, seq, heads, c_sb, c_sl, 64);
  if (e == cudaSuccess) e = bf16_rows_map(&tq, q, batch, seq, heads, q_sb, q_sl, q_sh);
  if (e == cudaSuccess) e = bf16_rows_map(&tdo, dout, batch, seq, heads, c_sb, c_sl, 64);
  if (e == cudaSuccess) e = bf16_rows_map(&tk, k, batch, seq, heads, k_sb, k_sl, k_sh);
  if (e == cudaSuccess) e = bf16_rows_map(&tv, v, batch, seq, heads, v_sb, v_sl, v_sh);
  if (e != cudaSuccess) return e;
  FlashBwdArgs p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.seq = seq;
  p.heads = heads;
  p.scale = 0.125f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = (long long)batch * seq * heads * 8;
  prep_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<bf16*>(qs), static_cast<float*>(delta), seq, heads, q_sb, q_sl, q_sh,
      0.125f * FA_LOG2E, chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((seq + BW_ROWS - 1) / BW_ROWS, heads, batch);
  flash_bwd_dq_kernel<<<grid, 384, DQ_SMEM, st>>>(tqs, tdo, tk, tv, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<<<grid, 384, DKV_SMEM, st>>>(tqs, tq, tdo, tk, tv, p);
  return cudaGetLastError();
}
