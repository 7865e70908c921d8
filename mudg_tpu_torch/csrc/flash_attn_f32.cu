// Kernels 5 and 6 in fp32: flash attention with its logsumexp, and its
// FlashAttention-2 backward, for fp32 q, k, v (B, L, H, 64), head dim 64.
// The functions are those of flash_attn.cu and flash_attn_bwd.cu:
//   o = softmax(q k^T / 8) v,  lse = logsumexp(q k^T / 8)  (natural log),
//   P = exp(q k^T / 8 - lse),  dS = P * (dO v^T - delta),
//   dq = dS k / 8,  dk = dS^T q / 8,  dv = P^T dO,  delta = rowsum(o * dO).
//
// Replaces: the same Pallas kernels (mudg_tpu/kernels/flash_attention.py,
// pallas_call at :132, :159 forward; :396, :412, :315, :331 backward), which
// take any dtype: an fp32 UNet forward (`sample`'s default dtype, `render
// --dtype f32`) sends its spatial self-attention at L >= 512 to them, and an
// fp32 training step their backward too. Numerics as those kernels in fp32
// (flash_attention.py:53-101, :181-242): q * d^-0.5 * log2(e) in fp32, the
// softmax in base 2, lse = m ln 2 + ln l, fp32 accumulators; their fp32
// operands take the MXU's multi-pass fp32 product (:54-56).
//
// Bound on this card: tensor-core issue. One TF32 product keeps 11 bits of
// each operand and misses the fp32 tolerance (1e-5 * max|o|) by ~50x, so
// every product is three (CUTLASS's 3xTF32, which PyTorch's fp32
// memory-efficient attention uses): with x = hi + lo, hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest (cvt.rna; a truncated hi brings
// lse within 2x of its bound), a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b in
// fp32 accumulators, the two small terms first, each tile's product over
// the sequence in an accumulator of its own, added to the running sum in
// fp32 (add_tile: the tensor core rounds its own sums toward zero, a bias
// that over thousands of keys in one accumulator missed the tolerance). At
// 495 TFLOP/s of tf32 that is 165 TFLOP/s of fp32 products, 2.5x the FMA
// units' 67: the MDM512 ds1 forward (32 x 2560 x 5 heads, 268 GFLOP) is
// bound at 1.63 ms (4.0 ms on FMAs).
//
// Design:
// - A pass before the kernels (split_tf32_kernel) writes each operand's hi
//   and lo copies: (2, B*H, L, 64) where the product reduces over the head
//   dims (q scaled by d^-0.5 log2(e) first, k, v, dO) and (2, B*H, 64, L)
//   where it reduces over the sequence (v forward; q, k and dO backward),
//   since tf32 wgmma takes both operands K-major only. The backward's pass
//   also writes delta.
// - The register A fragment of m64k8 holds columns c and c + 4 of each
//   8-column group where the fp32 accumulator holds 2c and 2c + 1 (hopper.cuh).
//   The pass stores the transposed copies' sequence axis in each 8-group in
//   the order [0, 2, 4, 6, 1, 3, 5, 7] (perm8), so P and dS, split in
//   registers, are the A operand as the accumulator holds them (tf32_frag).
// - Forward: one block of three warpgroups per (128 queries, head, batch).
//   Warpgroup 0 is the producer (setmaxnreg 24): one thread loads the
//   block's q (hi, lo) by TMA, then keeps a ring of two 64-key stages (K and
//   V^T, hi and lo, 64 KB) in flight. Warpgroups 1 and 2 (setmaxnreg 240)
//   own 64 query rows each: per stage S = Q K^T by 3 x 8 wgmma m64n64k8 from
//   shared memory, the base-2 online softmax in fp32 registers, P split into
//   hi and lo, then the tile's P V by 3 x 8 wgmma m64n64k8 with P from
//   registers, added to O. One warpgroup's softmax runs beside the other's
//   products.
// - Backward: two kernels, no atomics, so every gradient element is written
//   once by one block and reruns agree bit for bit. dq: one block per (128
//   queries, head, batch), the scaled q and dO (hi, lo) resident, a ring of
//   two 32-key stages of K, V and K^T; S and dP by m64n32k8 from shared
//   memory, dS in registers, dQ += dS K by m64n64k8. dk/dv: one block per
//   (128 keys, head, batch), K and V resident, a ring of three 32 KB slots
//   that takes each 32-query tile in two halves: the scaled q and dO (with
//   lse and delta) for S^T = K q_s^T and dP^T = V dO^T, then q^T and dO^T
//   for dV += P^T dO and dK += dS^T q.
// Shared memory: 192 KB (forward), 224 KB (dq, dk/dv) of the 227 a block
// may take: fp32 hi and lo tiles are four times a bf16 tile, so the rings
// are two stages deep and the consumers hold one stage at a time (the
// bf16 kernels' software pipeline would hold two).
// Rows past L of a block's resident tile arrive as zeros from TMA and are
// not stored (L % 128 may be 64).
// Not yet: the split inside the consumers (the pass writes twice an
// operand's bytes per copy), deeper rings with 32-column operand tiles.
#include "flash_fwd.cuh"

namespace mudg {

constexpr float T3_LOG2E = 1.4426950408889634f;
constexpr int T3_TILE = 64 * 64 * 4;   // bytes of a 64 x 64 fp32 tile (two 32-column boxes)
constexpr int T3_HALF = T3_TILE / 2;   // 32 x 64 (two boxes) or 64 x 32 (one box)
// forward: q hi, lo for 128 rows; per stage K hi, lo and V^T hi, lo (64 keys)
constexpr int F3_STAGES = 2;
constexpr int F3_SMEM = 1024 + 4 * T3_TILE + F3_STAGES * 4 * T3_TILE + 64;
// dq: q_s and dO hi, lo for 128 rows; per stage K, V (32 rows) and K^T (32
// keys), hi and lo
constexpr int DQ3_STAGE = 6 * T3_HALF;
constexpr int DQ3_SMEM = 1024 + 8 * T3_TILE + 2 * DQ3_STAGE + 64;
// dk/dv: K and V hi, lo for 128 rows; three slots of 32 KB and their lse and
// delta (64 fp32 each)
constexpr int DKV3_SLOT = 4 * T3_HALF;
constexpr int DKV3_SMEM = 1024 + 8 * T3_TILE + 3 * DKV3_SLOT + 3 * 256 + 64;
constexpr int MAX_SPLIT = 7;

// One operand of the pass: src (B, L, H, 64) through its element strides,
// times `scale`, into dst (hi copy, then the lo copy `plane` elements on).
struct SplitOp {
  const float* src;
  long long sb, sl, sh;
  float* dst;
  float scale;
  int transposed;   // dst (2, B*H, 64, L), the sequence in perm8 order
};

struct SplitArgs {
  SplitOp op[MAX_SPLIT];
  int nops, seq, heads;
  size_t plane;      // elements of one copy: B*H*L*64
  int delta_op;      // the operand (dO) whose rowsum with o is delta, or -1
  const float* o;    // (B, L, H, 64) contiguous
  float* delta;      // (B*H, L)
};

struct T3Args {
  const float* lse;    // backward
  const float* delta;  // backward
  float* o;            // forward output, or dq
  float* lse_out;      // forward
  float* dk;
  float* dv;
  int seq, heads;
};

// Position p of an 8-group of the transposed copies holds element perm8(p).
__device__ __forceinline__ int perm8(int p) { return p < 4 ? 2 * p : 2 * p - 7; }

__device__ __forceinline__ void split_store(float* dst, size_t plane, size_t off, float4 x) {
  uint32_t hi[4], lo[4];
  tf32_split(x.x, hi[0], lo[0]);
  tf32_split(x.y, hi[1], lo[1]);
  tf32_split(x.z, hi[2], lo[2]);
  tf32_split(x.w, hi[3], lo[3]);
  *reinterpret_cast<uint4*>(dst + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + plane + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// The pass: one block per (64 rows, head, batch x operand), 16 threads per
// row; a transposed operand goes through a shared 64 x 64 tile.
__global__ void __launch_bounds__(256) split_tf32_kernel(const __grid_constant__ SplitArgs a) {
  __shared__ float tile[64][65];
  const int l0 = blockIdx.x * 64, h = blockIdx.y;
  const int b = blockIdx.z / a.nops, j = blockIdx.z % a.nops;
  const SplitOp& op = a.op[j];
  const size_t bh = (size_t)b * a.heads + h;
  const int c = (threadIdx.x & 15) * 4;
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int r = pass * 16 + (threadIdx.x >> 4);
    float4 x = *reinterpret_cast<const float4*>(op.src + b * op.sb + (l0 + r) * op.sl +
                                                h * op.sh + c);
    if (j == a.delta_op) {
      const float4 ov = *reinterpret_cast<const float4*>(
          a.o + (((size_t)b * a.seq + l0 + r) * a.heads + h) * 64 + c);
      float acc = fmaf(x.x, ov.x, fmaf(x.y, ov.y, fmaf(x.z, ov.z, x.w * ov.w)));
#pragma unroll
      for (int m = 1; m < 16; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (c == 0) a.delta[bh * a.seq + l0 + r] = acc;
    }
    x = make_float4(x.x * op.scale, x.y * op.scale, x.z * op.scale, x.w * op.scale);
    if (op.transposed) {
      tile[r][c] = x.x;
      tile[r][c + 1] = x.y;
      tile[r][c + 2] = x.z;
      tile[r][c + 3] = x.w;
    } else {
      split_store(op.dst, a.plane, (bh * a.seq + l0 + r) * 64 + c, x);
    }
  }
  if (!op.transposed) return;   // the same for the whole block
  __syncthreads();
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int d = pass * 16 + (threadIdx.x >> 4);   // a head dim: a row of the copy
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = tile[((c + e) & ~7) + perm8((c + e) & 7)][d];
    split_store(op.dst, a.plane, (bh * 64 + d) * a.seq + l0 + c,
                make_float4(v[0], v[1], v[2], v[3]));
  }
}

// d = A B^T over the 64 head dims in 3xTF32, the two small terms first: A a
// K-major tile of 64 rows, B one of N rows, each as hi and lo descriptors.
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint64_t ahi, uint64_t alo,
                                        uint64_t bhi, uint64_t blo) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_tf32_ss<N>(d, alo + tf32_kstep<64>(kk), bhi + tf32_kstep<N>(kk), kk);
    wgmma_tf32_ss<N>(d, ahi + tf32_kstep<64>(kk), blo + tf32_kstep<N>(kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_ss<N>(d, ahi + tf32_kstep<64>(kk), bhi + tf32_kstep<N>(kk), 1);
}

// This thread's rows of a 64 x 64 accumulator, row half hh times scale[hh],
// into a contiguous (B, L, H, 64) fp32 tensor; rows past seq skipped.
__device__ __forceinline__ void store_rows_f32(float* out, const float (&d)[32],
                                               const float (&scale)[2], int row0, int seq,
                                               int heads, int h, int b, int qd) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= seq) continue;
    float* orow = out + (((size_t)b * seq + r) * heads + h) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * qd) =
          make_float2(d[4 * j + 2 * hh] * scale[hh], d[4 * j + 2 * hh + 1] * scale[hh]);
  }
}

__device__ __forceinline__ void init_ring(uint64_t* bars, int stages) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + stages + s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(384, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tvt, const T3Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* sq = sm;                    // per consumer warpgroup: q_s hi, lo (64 rows)
  uint8_t* skv = sm + 4 * T3_TILE;     // per stage: K hi, lo, V^T hi, lo
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + F3_STAGES * 4 * T3_TILE);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + F3_STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int q0 = blockIdx.x * 128, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.heads + h, ntiles = p.seq / 64;
  init_ring(bars, F3_STAGES);

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(bar_q, 4 * T3_TILE);
      for (int i = 0; i < 4; ++i)   // (warpgroup, hi or lo)
        for (int cb = 0; cb < 2; ++cb)
          tma_load_4d(sq + i * T3_TILE + cb * T3_HALF, &tq, bar_q, 32 * cb, q0 + 64 * (i >> 1),
                      bh, i & 1);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % F3_STAGES, k0 = 64 * t;
        if (t >= F3_STAGES) mbar_wait(&empty[s], ((t / F3_STAGES) - 1) & 1);
        uint8_t* st = skv + s * 4 * T3_TILE;
        mbar_expect_tx(&full[s], 4 * T3_TILE);
        for (int part = 0; part < 2; ++part)
          for (int cb = 0; cb < 2; ++cb) {
            tma_load_4d(st + part * T3_TILE + cb * T3_HALF, &tk, &full[s], 32 * cb, k0, bh,
                        part);
            tma_load_4d(st + (2 + part) * T3_TILE + cb * T3_HALF, &tvt, &full[s], k0 + 32 * cb,
                        0, bh, part);
          }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  setmaxnreg_inc<240>();
  const int cw = wg - 1, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const uint64_t dq_hi = sw128_desc(sq + 2 * cw * T3_TILE);
  const uint64_t dq_lo = sw128_desc(sq + (2 * cw + 1) * T3_TILE);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2], l[2], alpha[2];
  mbar_wait(bar_q, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % F3_STAGES;
    const uint8_t* st = skv + s * 4 * T3_TILE;
    mbar_wait(&full[s], (t / F3_STAGES) & 1);
    float sc[32];
    wgmma_fence();
    mma3_ss<64>(sc, dq_hi, dq_lo, sw128_desc(st), sw128_desc(st + T3_TILE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (t == 0)
      online_softmax<true>(sc, m, l, alpha);
    else
      online_softmax<false>(sc, m, l, alpha);
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) tf32_frag(ph[j], pl[j], sc, j);
    float pv[32];
    wgmma_fence();
    mma3_rs<8>(pv, ph, pl, sw128_desc(st + 2 * T3_TILE), sw128_desc(st + 3 * T3_TILE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(&empty[s]);
    add_tile(o, pv, alpha);   // alpha is 1 on the first tile, where o is 0
  }
  const float sum[2] = {quad_sum(l[0]), quad_sum(l[1])};
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
  const int row0 = q0 + cw * 64 + warp * 16 + g;
  store_rows_f32(p.o, o, inv, row0, p.seq, p.heads, h, b, qd);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (qd == 0 && row0 + 8 * hh < p.seq)
      p.lse_out[(size_t)bh * p.seq + row0 + 8 * hh] =
          m[hh] * 0.6931471805599453f + logf(sum[hh]);
}

__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tqs,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tkt, const T3Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* res = sm;                     // per warpgroup: q_s hi, lo, dO hi, lo (64 rows)
  uint8_t* stages = sm + 8 * T3_TILE;    // per stage: K hi, lo, V hi, lo, K^T hi, lo
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + 2 * DQ3_STAGE);
  uint64_t* bar_res = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int q0 = blockIdx.x * 128, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.heads + h, ntiles = p.seq / 32;
  init_ring(bars, 2);

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(bar_res, 8 * T3_TILE);
      for (int i = 0; i < 8; ++i)   // (warpgroup, q_s or dO, hi or lo)
        for (int cb = 0; cb < 2; ++cb)
          tma_load_4d(res + i * T3_TILE + cb * T3_HALF, (i >> 1) & 1 ? &tdo : &tqs, bar_res,
                      32 * cb, q0 + 64 * (i >> 2), bh, i & 1);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % 2;
        if (t >= 2) mbar_wait(&empty[s], ((t / 2) - 1) & 1);
        uint8_t* st = stages + s * DQ3_STAGE;
        mbar_expect_tx(&full[s], DQ3_STAGE);
        for (int i = 0; i < 4; ++i)   // (K or V, hi or lo): 32 rows
          for (int cb = 0; cb < 2; ++cb)
            tma_load_4d(st + i * T3_HALF + cb * (T3_HALF / 2), i >> 1 ? &tv : &tk, &full[s],
                        32 * cb, 32 * t, bh, i & 1);
        for (int part = 0; part < 2; ++part)
          tma_load_4d(st + (4 + part) * T3_HALF, &tkt, &full[s], 32 * t, 0, bh, part);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  setmaxnreg_inc<240>();
  const int cw = wg - 1, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = q0 + cw * 64 + warp * 16 + g;
  const size_t srow = (size_t)bh * p.seq;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    lse2[hh] = r < p.seq ? p.lse[srow + r] * T3_LOG2E : 0.f;
    dl[hh] = r < p.seq ? p.delta[srow + r] : 0.f;
  }
  const uint8_t* mine = res + 4 * cw * T3_TILE;
  const uint64_t dqs_hi = sw128_desc(mine), dqs_lo = sw128_desc(mine + T3_TILE);
  const uint64_t ddo_hi = sw128_desc(mine + 2 * T3_TILE), ddo_lo = sw128_desc(mine + 3 * T3_TILE);
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  const float one[2] = {1.f, 1.f};
  mbar_wait(bar_res, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % 2;
    const uint8_t* st = stages + s * DQ3_STAGE;
    mbar_wait(&full[s], (t / 2) & 1);
    float sc[16], dp[16];   // rows: this warpgroup's queries; columns: the stage's 32 keys
    wgmma_fence();
    mma3_ss<32>(sc, dqs_hi, dqs_lo, sw128_desc(st), sw128_desc(st + T3_HALF));
    mma3_ss<32>(dp, ddo_hi, ddo_lo, sw128_desc(st + 2 * T3_HALF), sw128_desc(st + 3 * T3_HALF));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int hh = (i >> 1) & 1;
      sc[i] = exp2f(sc[i] - lse2[hh]) * (dp[i] - dl[hh]);
    }
    uint32_t dsh[4][4], dsl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) tf32_frag(dsh[j], dsl[j], sc, j);
    float part[32];
    wgmma_fence();
    mma3_rs<4>(part, dsh, dsl, sw128_desc(st + 4 * T3_HALF), sw128_desc(st + 5 * T3_HALF));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(dsh);
    fence_regs(dsl);
    mbar_arrive(&empty[s]);
    add_tile(dq, part, one);
  }
  const float scale[2] = {0.125f, 0.125f};
  store_rows_f32(p.o, dq, scale, row0, p.seq, p.heads, h, b, qd);
}

__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tqs,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tqt,
                              const __grid_constant__ CUtensorMap tdot, const T3Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* res = sm;                   // per warpgroup: K hi, lo, V hi, lo (64 rows)
  uint8_t* slots = sm + 8 * T3_TILE;   // q_s hi, lo, dO hi, lo or q^T hi, lo, dO^T hi, lo
  float* stats = reinterpret_cast<float*>(slots + 3 * DKV3_SLOT);   // per slot: lse, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 3 * 64);
  uint64_t* bar_res = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 4;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int k0 = blockIdx.x * 128, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.heads + h, ntiles = p.seq / 32;
  const size_t srow = (size_t)bh * p.seq;   // this (b, h)'s lse / delta row
  init_ring(bars, 3);

  if (wg == 0) {  // producer: item 2t is tile t's first half, 2t + 1 its second
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(bar_res, 8 * T3_TILE);
      for (int i = 0; i < 8; ++i)   // (warpgroup, K or V, hi or lo)
        for (int cb = 0; cb < 2; ++cb)
          tma_load_4d(res + i * T3_TILE + cb * T3_HALF, (i >> 1) & 1 ? &tv : &tk, bar_res,
                      32 * cb, k0 + 64 * (i >> 2), bh, i & 1);
      for (int i = 0; i < 2 * ntiles; ++i) {
        const int s = i % 3, q0 = 32 * (i / 2);
        if (i >= 3) mbar_wait(&empty[s], ((i / 3) - 1) & 1);
        uint8_t* st = slots + s * DKV3_SLOT;
        if ((i & 1) == 0) {
          mbar_expect_tx(&full[s], DKV3_SLOT + 256);
          for (int j = 0; j < 4; ++j)   // (q_s or dO, hi or lo): 32 rows
            for (int cb = 0; cb < 2; ++cb)
              tma_load_4d(st + j * T3_HALF + cb * (T3_HALF / 2), j >> 1 ? &tdo : &tqs,
                          &full[s], 32 * cb, q0, bh, j & 1);
          bulk_load(stats + 64 * s, p.lse + srow + q0, 128, &full[s]);
          bulk_load(stats + 64 * s + 32, p.delta + srow + q0, 128, &full[s]);
        } else {
          mbar_expect_tx(&full[s], DKV3_SLOT);
          for (int j = 0; j < 4; ++j)   // (q^T or dO^T, hi or lo): 32 queries
            tma_load_4d(st + j * T3_HALF, j >> 1 ? &tdot : &tqt, &full[s], q0, 0, bh, j & 1);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns key rows k0 + 64 cw .. + 63
  setmaxnreg_inc<240>();
  const int cw = wg - 1, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const uint8_t* mine = res + 4 * cw * T3_TILE;
  const uint64_t dk_hi = sw128_desc(mine), dk_lo = sw128_desc(mine + T3_TILE);
  const uint64_t dv_hi = sw128_desc(mine + 2 * T3_TILE), dv_lo = sw128_desc(mine + 3 * T3_TILE);
  float dv[32], dk[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv[i] = dk[i] = 0.f;
  const float one[2] = {1.f, 1.f};
  mbar_wait(bar_res, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = (2 * t) % 3, s2 = (2 * t + 1) % 3;
    const uint8_t* st = slots + s * DKV3_SLOT;
    mbar_wait(&full[s], ((2 * t) / 3) & 1);
    float sT[16], dpT[16];   // rows: this warpgroup's keys; columns: the tile's 32 queries
    wgmma_fence();
    mma3_ss<32>(sT, dk_hi, dk_lo, sw128_desc(st), sw128_desc(st + T3_HALF));
    mma3_ss<32>(dpT, dv_hi, dv_lo, sw128_desc(st + 2 * T3_HALF), sw128_desc(st + 3 * T3_HALF));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
    const float* lse_s = stats + 64 * s;
    const float* dl_s = lse_s + 32;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * qd + (e & 1);
        const float pt = exp2f(sT[4 * j + e] - lse_s[col] * T3_LOG2E);
        sT[4 * j + e] = pt;
        dpT[4 * j + e] = pt * (dpT[4 * j + e] - dl_s[col]);
      }
    mbar_arrive(&empty[s]);   // the first half (and its lse, delta) is read
    const uint8_t* st2 = slots + s2 * DKV3_SLOT;
    mbar_wait(&full[s2], ((2 * t + 1) / 3) & 1);
    // dV += P^T dO, then dK += dS^T q, one tile accumulator between them
    float part[32];
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) tf32_frag(ah[j], al[j], sT, j);
    wgmma_fence();
    mma3_rs<4>(part, ah, al, sw128_desc(st2 + 2 * T3_HALF), sw128_desc(st2 + 3 * T3_HALF));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(ah);
    fence_regs(al);
    add_tile(dv, part, one);
#pragma unroll
    for (int j = 0; j < 4; ++j) tf32_frag(ah[j], al[j], dpT, j);
    wgmma_fence();
    mma3_rs<4>(part, ah, al, sw128_desc(st2), sw128_desc(st2 + T3_HALF));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(ah);
    fence_regs(al);
    mbar_arrive(&empty[s2]);
    add_tile(dk, part, one);
  }
  const int row0 = k0 + cw * 64 + warp * 16 + g;
  const float scale[2] = {0.125f, 0.125f};
  store_rows_f32(p.dk, dk, scale, row0, p.seq, p.heads, h, b, qd);
  store_rows_f32(p.dv, dv, one, row0, p.seq, p.heads, h, b, qd);
}

static SplitOp split_op(const void* src, long long sb, long long sl, long long sh, float* dst,
                        float scale, int transposed) {
  return SplitOp{static_cast<const float*>(src), sb, sl, sh, dst, scale, transposed};
}

static cudaError_t launch_split(const SplitArgs& a, int batch, cudaStream_t stream) {
  split_tf32_kernel<<<dim3(a.seq / 64, a.heads, batch * a.nops), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace mudg

namespace mudg_host {

// A tensor map over split copies (2, B*H, L, 64) fp32, as dims (64, L,
// B*H, 2), with boxes of 32 columns by `rows` rows; rows past L read as
// zeros.
static inline cudaError_t split_rows_map(CUtensorMap* map, const float* base, int bh, int seq,
                                         int rows) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)seq, (cuuint64_t)bh, 2};
  const cuuint64_t strides[3] = {256, (cuuint64_t)seq * 256, (cuuint64_t)bh * seq * 256};
  const cuuint32_t box[4] = {32, (cuuint32_t)rows, 1, 1};
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 4, dims, strides, box);
}

// A tensor map over transposed split copies (2, B*H, 64, L) fp32, as dims
// (L, 64, B*H, 2), with boxes of 32 sequence positions by the 64 head dims.
static inline cudaError_t split_cols_map(CUtensorMap* map, const float* base, int bh, int seq) {
  const cuuint64_t dims[4] = {(cuuint64_t)seq, 64, (cuuint64_t)bh, 2};
  const cuuint64_t strides[3] = {(cuuint64_t)seq * 4, (cuuint64_t)seq * 256,
                                 (cuuint64_t)bh * seq * 256};
  const cuuint32_t box[4] = {32, 64, 1, 1};
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 4, dims, strides, box);
}

}  // namespace mudg_host

using namespace mudg;
using mudg_host::split_cols_map;
using mudg_host::split_rows_map;

// q, k, v: (batch, seq, heads, 64) fp32 with the given element strides (head
// dim contiguous, every stride a multiple of 4, 16-byte aligned pointers);
// o: (batch, seq, heads, 64) fp32 contiguous; lse: (batch*heads, seq) fp32;
// work: scratch for 3 x 2 x batch*heads*seq*64 fp32 (the split copies of
// the scaled q, k and v^T). seq % 64 == 0.
extern "C" int mudg_flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                                   void* lse, void* work, int batch, int seq, int heads,
                                   long long q_sb, long long q_sl, long long q_sh,
                                   long long k_sb, long long k_sl, long long k_sh,
                                   long long v_sb, long long v_sl, long long v_sh,
                                   void* stream) {
  // raised once per host thread, as launch_flash_fwd
  thread_local bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, F3_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int bh = batch * heads;
  const size_t plane = (size_t)bh * seq * 64;
  float* w = static_cast<float*>(work);
  SplitArgs a = {};
  a.op[0] = split_op(q, q_sb, q_sl, q_sh, w, 0.125f * T3_LOG2E, 0);
  a.op[1] = split_op(k, k_sb, k_sl, k_sh, w + 2 * plane, 1.f, 0);
  a.op[2] = split_op(v, v_sb, v_sl, v_sh, w + 4 * plane, 1.f, 1);
  a.nops = 3;
  a.seq = seq;
  a.heads = heads;
  a.plane = plane;
  a.delta_op = -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_split(a, batch, st);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tvt;
  e = split_rows_map(&tq, w, bh, seq, 64);
  if (e == cudaSuccess) e = split_rows_map(&tk, w + 2 * plane, bh, seq, 64);
  if (e == cudaSuccess) e = split_cols_map(&tvt, w + 4 * plane, bh, seq);
  if (e != cudaSuccess) return e;
  T3Args p = {};
  p.o = static_cast<float*>(o);
  p.lse_out = static_cast<float*>(lse);
  p.seq = seq;
  p.heads = heads;
  flash_fwd_tf32_kernel<<<dim3((seq + 127) / 128, heads, batch), 384, F3_SMEM, st>>>(tq, tk,
                                                                                      tvt, p);
  return cudaGetLastError();
}

// As mudg_flash_attn_bwd in fp32: o, dout, dq, dk, dv (batch, seq, heads,
// 64) contiguous; lse (batch*heads, seq); delta: scratch (batch*heads, seq)
// for rowsum(o * dO); work: scratch for 7 x 2 x batch*heads*seq*64 fp32.
extern "C" int mudg_flash_attn_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, void* work,
                                       int batch, int seq, int heads, long long q_sb,
                                       long long q_sl, long long q_sh, long long k_sb,
                                       long long k_sl, long long k_sh, long long v_sb,
                                       long long v_sl, long long v_sh, void* stream) {
  thread_local bool configured = false;
  if (!configured) {
    const cudaFuncAttribute smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel, smem, DQ3_SMEM);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(flash_bwd_dkv_tf32_kernel, smem, DKV3_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int bh = batch * heads;
  const size_t plane = (size_t)bh * seq * 64;
  const long long c_sl = (long long)heads * 64, c_sb = c_sl * seq;   // contiguous strides
  float* w = static_cast<float*>(work);
  // the copies: 0 q_s, 1 k, 2 v, 3 dO (+ delta), 4 q^T, 5 k^T, 6 dO^T
  SplitArgs a = {};
  a.op[0] = split_op(q, q_sb, q_sl, q_sh, w, 0.125f * T3_LOG2E, 0);
  a.op[1] = split_op(k, k_sb, k_sl, k_sh, w + 2 * plane, 1.f, 0);
  a.op[2] = split_op(v, v_sb, v_sl, v_sh, w + 4 * plane, 1.f, 0);
  a.op[3] = split_op(dout, c_sb, c_sl, 64, w + 6 * plane, 1.f, 0);
  a.op[4] = split_op(q, q_sb, q_sl, q_sh, w + 8 * plane, 1.f, 1);
  a.op[5] = split_op(k, k_sb, k_sl, k_sh, w + 10 * plane, 1.f, 1);
  a.op[6] = split_op(dout, c_sb, c_sl, 64, w + 12 * plane, 1.f, 1);
  a.nops = 7;
  a.seq = seq;
  a.heads = heads;
  a.plane = plane;
  a.delta_op = 3;
  a.o = static_cast<const float*>(o);
  a.delta = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_split(a, batch, st);
  if (e != cudaSuccess) return e;
  CUtensorMap tqs, tdo, tk32, tv32, tkt, tk, tv, tqs32, tdo32, tqt, tdot;
  e = split_rows_map(&tqs, w, bh, seq, 64);
  if (e == cudaSuccess) e = split_rows_map(&tdo, w + 6 * plane, bh, seq, 64);
  if (e == cudaSuccess) e = split_rows_map(&tk32, w + 2 * plane, bh, seq, 32);
  if (e == cudaSuccess) e = split_rows_map(&tv32, w + 4 * plane, bh, seq, 32);
  if (e == cudaSuccess) e = split_cols_map(&tkt, w + 10 * plane, bh, seq);
  if (e == cudaSuccess) e = split_rows_map(&tk, w + 2 * plane, bh, seq, 64);
  if (e == cudaSuccess) e = split_rows_map(&tv, w + 4 * plane, bh, seq, 64);
  if (e == cudaSuccess) e = split_rows_map(&tqs32, w, bh, seq, 32);
  if (e == cudaSuccess) e = split_rows_map(&tdo32, w + 6 * plane, bh, seq, 32);
  if (e == cudaSuccess) e = split_cols_map(&tqt, w + 8 * plane, bh, seq);
  if (e == cudaSuccess) e = split_cols_map(&tdot, w + 12 * plane, bh, seq);
  if (e != cudaSuccess) return e;
  T3Args p = {};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.o = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.seq = seq;
  p.heads = heads;
  const dim3 grid((seq + 127) / 128, heads, batch);
  flash_bwd_dq_tf32_kernel<<<grid, 384, DQ3_SMEM, st>>>(tqs, tdo, tk32, tv32, tkt, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_tf32_kernel<<<grid, 384, DKV3_SMEM, st>>>(tk, tv, tqs32, tdo32, tqt, tdot, p);
  return cudaGetLastError();
}
