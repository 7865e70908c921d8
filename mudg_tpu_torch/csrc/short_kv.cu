// Kernel 12, short-KV form, bf16, head dim D = 64 or 128, 1 <= Lk <= 1024:
//   o = softmax(q k^T / sqrt(D)) v,  q (B, Lq, H, D) over k, v (B, Lk, H, D),
// fp32 logits scaled after the product, keys past Lk masked, an fp32
// softmax, P rounded to bf16 for P V. The fp32 form is short_kv_f32.cu; the
// wrapper picks the route and the launch plan
// (kernels/short_attention.short_kv_route, short_kv_plan).
//
// Replaces: mudg_tpu/kernels/short_attention.py:_short_kv_kernel
// (short_kv_attention, pallas_call at :214).
//
// Bound on this card: bytes at every MuDG site (Lk 77 and 16, D 64: at
// MDM512 ds1, 32 x 2560 queries, 5 heads, q and o are 105 MB, 31 us at
// 3.35 TB/s, against 8.1 GFLOP, 8 us at 989 TFLOP/s) and at D 128 (Lk 77:
// 210 MB, 63 us); operations from Lk ~ 300 at D 64 (Lk 1024: 107.4 GFLOP,
// 109 us).
//
// Design: consumer warpgroups and one producer warp (one thread issues
// every TMA load through 4-D tensor maps (D, H, L, B): k and v may be
// strided views of one k|v buffer, rows past L arrive as zeros). A q tile
// is 64 rows by D / 64 column boxes of 64 swizzled bf16 columns. S = Q K^T
// is wgmma m64nNk16 with K in shared memory (K-major, D / 16 k16 steps; Q
// from shared memory too, or from registers, below), the logits are
// scaled and the keys past Lk masked to -inf in fp32 registers, and O = P V
// is wgmma m64n64k16 per 64 head dims with P from registers (the S
// accumulator rounded to bf16 is the A fragment) and V read through the
// transpose bit. Each warpgroup writes its o tile, swizzled, to its own
// staging tile, and one thread stores it by TMA as whole 128-byte rows.
// - Whole K/V (Lk <= 128, every MuDG site): one block of two consumer
//   warpgroups per (span of q tiles, head, batch) loads the pair's K and V
//   once (N = Lk rounded up to 16 keys) and streams the span's q tiles
//   through a ring; warpgroups take alternate tiles. P is normalised before its bf16 rounding, as the
//   reference does (short_attention.py:174-180). Two blocks fit an SM at D
//   64 and N <= 80 (81 KB), so one block's loads overlap the other's
//   products; one at D 128 (161 KB).
// - Streamed K/V (Lk 129-1024: K and V of one pair are up to 256 KB at D
//   64): a persistent block per SM walks items of NW consecutive q tiles of
//   one (batch, head) pair (sk_stream_wgs: three consumer warpgroups at D
//   64, two at D 128), a tile a warpgroup; all of them walk the pair's
//   keys in 64-key chunks, which the producer streams through a ring of
//   K|V stages (one load serves every tile of the item; the pair's chunks
//   stay in L2 while the SMs that share it walk it) while the next item's
//   q tiles load. Per chunk a warpgroup issues one product batch, P V of
//   chunk c and S of chunk c + 1, and the warpgroups issue their batches in
//   turns (named barriers), so one's softmax runs beside the others'
//   products. At D 64, S takes Q from registers (ldmatrix once per item):
//   S with both operands in shared memory at N = 64 would read as many
//   bytes a cycle as the SM's shared memory gives. The softmax is online
//   in fp32 registers (running max and sum, O rescaled per chunk, P =
//   2^(scale s - m) with the scale in one FFMA) in one pass over the keys,
//   so P is rounded to bf16 before it is normalised, as kernel 5 rounds
//   it; two passes (normalising first, as the reference does) would take
//   1.5x the products at Lk 1024. The difference is within the bf16
//   tolerance (ROADMAP.md, known differences). At D 64 the exponentials
//   (one per 128 products, on the SFU) take as long as the products at
//   the tensor cores' peak, so the kernel cannot pass about half of that
//   peak without moving exponentials to the FMA units (not done).
// ptxas allots registers by whole warpgroups: 288 threads may use 168 a
// thread, 416 (three consumer warpgroups and the producer warp) 128
// (build.log; chip_smoke.py's NO_SPILL fails the build on a spill).
#include "hopper.cuh"

namespace mudg {

constexpr int SK_ROWS = 64;          // query rows per tile (one warpgroup)
constexpr int SK_KEYS = 64;          // keys of a streamed chunk
constexpr int SK_BOX = 64 * 64 * 2;  // bytes of a box of 64 rows by 64 columns
constexpr int SK_THREADS = 288;      // two consumer warpgroups + the producer warp

struct ShortKvArgs {
  int lk;       // keys
  int span;     // whole: q tiles per block; streamed: items (NW q tiles of a pair) in all
  int tiles;    // q tiles per (batch, head)
  int heads;
  int stages;   // whole: q tiles in flight; streamed: K|V chunks in flight
  float scale;  // d^-0.5 * log2(e): logits in base 2, scaled in fp32
};

// S = Q K^T over D / 16 k16 steps: the 64-row q tile at dq (column boxes
// SK_BOX apart) by the N-row K tile at dk (column boxes kbox bytes apart).
template <int D, int N>
__device__ __forceinline__ void sk_logits(float (&sc)[N / 2], uint64_t dq, uint64_t dk,
                                          int kbox) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(sc, dq + (kk & 3) * KMAJOR_K16 + (kk >> 2) * (SK_BOX >> 4),
                dk + (kk & 3) * KMAJOR_K16 + (uint64_t)((kk >> 2) * (kbox >> 4)), kk);
}

// O += P V over NK keys: V's column box hf (64 head dims) at dv + hf * vbox
// bytes, read MN-major (rows the keys).
template <int D, int NK>
__device__ __forceinline__ void sk_pv(float (&o)[D / 64][32], const uint32_t (&pa)[NK / 16][4],
                                      uint64_t dv, int vbox) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma_rs_n64_tb(o[hf], pa[kk], dv + (uint64_t)(hf * (vbox >> 4)) + kk * MNMAJOR_K16);
}

// Scale the logits of keys key0 + (this thread's columns) in fp32 and mask
// those at or past lk to -inf.
template <int N>
__device__ __forceinline__ void sk_scale_mask(float (&sc)[N / 2], int key0, int lk, float scale,
                                              int qd) {
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& v = sc[4 * jj + e];
      v = key0 + 8 * jj + 2 * qd + (e & 1) < lk ? v * scale : -INFINITY;
    }
}

// This warpgroup's 64 x D o tile (rows scaled by inv[row half]) to its
// staging tile, swizzled, then one thread stores it by TMA to rows row ..
// of head h, batch b. The staging tile is free once the last store from it
// has read it (bulk_wait_read by the storing thread, then the barrier).
template <int D>
__device__ __forceinline__ void sk_store(const CUtensorMap* to, uint8_t* stg,
                                         const float (&o)[D / 64][32], const float (&inv)[2],
                                         int h, int row, int b, int cw, int tid) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, qd = tid & 3;
  if (tid == 0) bulk_wait_read<0>();
  named_bar_sync(1 + cw, 128);
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * warp + g + 8 * hh;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(stg + hf * SK_BOX + sw128_offset(r, 8 * jj + 2 * qd, 64)) =
            pack_bf16x2(o[hf][4 * jj + 2 * hh] * inv[hh], o[hf][4 * jj + 2 * hh + 1] * inv[hh]);
    }
  fence_proxy_async();
  named_bar_sync(1 + cw, 128);
  if (tid == 0) {
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf) tma_store_4d(to, stg + hf * SK_BOX, 64 * hf, h, row, b);
    bulk_commit();
  }
}

// A 64-row box of every column box of a (D, H, L, B) map: D / 64 boxes,
// `step` bytes apart in dst.
template <int D>
__device__ __forceinline__ void sk_load(uint8_t* dst, int step, const CUtensorMap* map,
                                        uint64_t* bar, int h, int row, int b) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf) tma_load_4d(dst + hf * step, map, bar, 64 * hf, h, row, b);
}

// 2^x on the SFU (ex2.approx, subnormal results flushed to zero: P below
// 2^-126 adds nothing a bf16 product keeps).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of chunk c's raw logits sc (64 keys) for rows g and g +
// 8: keys past lk masked (last chunk), the running max m of the scaled
// logits, P = 2^(scale s - m) with the scale in one FFMA, this thread's
// part of the row sums l, O rescaled by 2^(m_old - m_new) (0 on the first
// chunk), and P rounded to bf16 as the A operand of P V.
template <int D>
__device__ __forceinline__ void sk_online_softmax(float (&sc)[SK_KEYS / 2],
                                                  uint32_t (&pa)[SK_KEYS / 16][4],
                                                  float (&o)[D / 64][32], float (&m)[2],
                                                  float (&l)[2], int c, int nch, int lk,
                                                  float scale, int qd) {
  if (c == nch - 1 && lk % SK_KEYS) sk_scale_mask<SK_KEYS>(sc, SK_KEYS * c, lk, 1.f, qd);
  // max and sum as trees (short dependency chains: the softmax's latency is
  // what the other warpgroups' products must cover)
  constexpr int R = SK_KEYS / 4;  // this thread's values in each of its two rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float t[R / 2];
#pragma unroll
    for (int jj = 0; jj < R / 2; ++jj) t[jj] = fmaxf(sc[4 * jj + 2 * hh], sc[4 * jj + 2 * hh + 1]);
#pragma unroll
    for (int w = R / 4; w >= 1; w /= 2)
#pragma unroll
      for (int jj = 0; jj < w; ++jj) t[jj] = fmaxf(t[jj], t[jj + w]);
    const float mnew = fmaxf(m[hh], quad_max(t[0]) * scale);
    const float alpha = ex2(m[hh] - mnew);
    m[hh] = mnew;
#pragma unroll
    for (int jj = 0; jj < R / 2; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = sc[4 * jj + 2 * hh + e];
        v = ex2(fmaf(v, scale, -mnew));
      }
#pragma unroll
    for (int jj = 0; jj < R / 2; ++jj) t[jj] = sc[4 * jj + 2 * hh] + sc[4 * jj + 2 * hh + 1];
#pragma unroll
    for (int w = R / 4; w >= 1; w /= 2)
#pragma unroll
      for (int jj = 0; jj < w; ++jj) t[jj] += t[jj + w];
    l[hh] = l[hh] * alpha + t[0];
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        o[hf][4 * jj + 2 * hh] *= alpha;
        o[hf][4 * jj + 2 * hh + 1] *= alpha;
      }
  }
#pragma unroll
  for (int kk = 0; kk < SK_KEYS / 16; ++kk) acc_to_a(pa[kk], sc, kk);
}

// S = Q K^T with Q's A fragments in registers (qf, k16 step kk: rows 16 w +
// g and + 8 of this warp, columns 16 kk + 2 q .. as acc_to_a lays them out)
// and the 64-key K chunk at dk (K-major), head dim 64.
__device__ __forceinline__ void sk_logits_rs(float (&sc)[32], const uint32_t (&qf)[4][4],
                                             uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(sc, qf[kk], dk + kk * KMAJOR_K16, kk);
}

// ---- whole K/V (NK = Lk rounded up to 16 <= 128) ----------------------------

__host__ __device__ constexpr int sk_kv_boxes(int nk) { return (nk + 63) / 64; }
__host__ __device__ constexpr int sk_whole_smem(int d, int nk, int stages) {
  return 1024 + (d / 64) * (2 * sk_kv_boxes(nk) + stages + 2) * SK_BOX + 8 * (1 + 2 * stages);
}

template <int D, int NK>
__global__ void __launch_bounds__(SK_THREADS, D == 64 && NK <= 80 ? 2 : 1)
    short_kv_tma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap to, const ShortKvArgs p) {
  constexpr int KB = sk_kv_boxes(NK), QT = (D / 64) * SK_BOX, KV = KB * SK_BOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);  // K: D / 64 column boxes of KB 64-key boxes
  uint8_t* sv = sk + (D / 64) * KV;   // V: the same
  uint8_t* sq = sv + (D / 64) * KV;   // the q ring
  uint8_t* staging = sq + p.stages * QT;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(staging + 2 * QT);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + p.stages;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * p.span, n = min(p.span, p.tiles - t0);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);  // tile i belongs to warpgroup i % 2, which releases it
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_kv, 2 * (D / 64) * KV);
      for (int bx = 0; bx < KB; ++bx) {
        sk_load<D>(sk + bx * SK_BOX, KV, &tk, bar_kv, h, 64 * bx, b);
        sk_load<D>(sv + bx * SK_BOX, KV, &tv, bar_kv, h, 64 * bx, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % p.stages;
        if (i >= p.stages) mbar_wait(&empty[s], ((i / p.stages) - 1) & 1);
        mbar_expect_tx(&full[s], QT);
        sk_load<D>(sq + s * QT, SK_BOX, &tq, &full[s], h, (t0 + i) * SK_ROWS, b);
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128, qd = tid & 3;
  uint8_t* stg = staging + cw * QT;
  const uint64_t dk = sw128_desc(sk), dv = sw128_desc(sv);
  mbar_wait(bar_kv, 0);
  for (int i = cw; i < n; i += 2) {
    const int s = i % p.stages;
    mbar_wait(&full[s], (i / p.stages) & 1);
    float sc[NK / 2];
    wgmma_fence();
    sk_logits<D, NK>(sc, sw128_desc(sq + s * QT), dk, KV);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (tid == 0) mbar_arrive(&empty[s]);

    // softmax over the Lk keys of rows g and g + 8 of this warp's 16, P
    // normalised before its bf16 rounding
    sk_scale_mask<NK>(sc, 0, p.lk, p.scale, qd);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < NK / 8; ++jj)
        mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * hh], sc[4 * jj + 2 * hh + 1]));
      mx = quad_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < NK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[4 * jj + 2 * hh + e];
          v = exp2f(v - mx);
          sum += v;
        }
      const float inv = 1.f / quad_sum(sum);
#pragma unroll
      for (int jj = 0; jj < NK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) sc[4 * jj + 2 * hh + e] *= inv;
    }
    uint32_t pa[NK / 16][4];
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) acc_to_a(pa[kk], sc, kk);

    float o[D / 64][32];
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf) {
#pragma unroll
      for (int e = 0; e < 32; ++e) o[hf][e] = 0.f;
      fence_regs(o[hf]);
    }
    fence_regs(pa);
    wgmma_fence();
    sk_pv<D, NK>(o, pa, dv, KV);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf) fence_regs(o[hf]);
    fence_regs(pa);  // wgmma reads its register A operand until the wait

    const float one[2] = {1.f, 1.f};
    sk_store<D>(&to, stg, o, one, h, (t0 + i) * SK_ROWS, b, cw, tid);
  }
  if (tid == 0) bulk_wait<0>();
}

// ---- streamed K/V (Lk > 128) ------------------------------------------------

// consumer warpgroups of the streamed kernel: three at D 64, two at D 128.
// ptxas allots registers by whole warpgroups (416 threads as 512: 128 a
// thread, D 64 takes 128; 288 as 384: 168, D 128 takes 144); four at D 64
// would leave 96 and spill.
__host__ __device__ constexpr int sk_stream_wgs(int d) { return d == 64 ? 3 : 2; }
__host__ __device__ constexpr int sk_stream_smem(int d, int stages) {
  return 1024 + (d / 64) * (3 * sk_stream_wgs(d) + 2 * stages) * SK_BOX + 8 * (4 + 2 * stages);
}

template <int D>
__global__ void __launch_bounds__(128 * sk_stream_wgs(D) + 32, 1)
    short_kv_stream_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, const ShortKvArgs p) {
  constexpr int NW = sk_stream_wgs(D), CT = 128 * NW;  // consumer warpgroups and threads
  constexpr int QT = (D / 64) * SK_BOX, CH = 2 * QT;  // bytes of a q tile, of a K|V chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);  // two stages of an item's NW q tiles
  uint8_t* skv = sq + 2 * NW * QT;    // p.stages chunks: K's column boxes, then V's
  uint8_t* staging = skv + p.stages * CH;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(staging + NW * QT);
  uint64_t* qempty = qfull + 2;
  uint64_t* kvfull = qempty + 2;
  uint64_t* kvempty = kvfull + p.stages;
  // items: NW consecutive q tiles of one (batch, head) pair; the last of a
  // pair's may run past Lq, where the loads read zeros and the stores write
  // nothing
  const int nch = (p.lk + SK_KEYS - 1) / SK_KEYS, groups = (p.tiles + NW - 1) / NW;
  const int n = p.span > (int)blockIdx.x ? (p.span - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], CT);  // every consumer thread, after its last read of q
    }
    // a K|V stage is released by one thread of each consumer warpgroup,
    // after its wait for the products that read it
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&kvfull[s], 1);
      mbar_init(&kvempty[s], NW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CT) {  // producer
    if (threadIdx.x == CT) {
      auto load_q = [&](int i) {  // item i's q tiles into stage i % 2
        const int it = blockIdx.x + i * gridDim.x, pr = it / groups, tg = it % groups;
        uint64_t* bar = &qfull[i & 1];
        mbar_expect_tx(bar, NW * QT);
        for (int w = 0; w < NW; ++w)
          sk_load<D>(sq + (NW * (i & 1) + w) * QT, SK_BOX, &tq, bar, pr % p.heads,
                     (NW * tg + w) * SK_ROWS, pr / p.heads);
      };
      if (n > 0) load_q(0);
      if (n > 1) load_q(1);
      const int cq = min(p.stages, nch) - 1;
      int g = 0;
      for (int i = 0; i < n; ++i) {
        const int pr = (blockIdx.x + i * gridDim.x) / groups, h = pr % p.heads, b = pr / p.heads;
        for (int c = 0; c < nch; ++c, ++g) {
          const int s = g % p.stages;
          if (g >= p.stages) mbar_wait(&kvempty[s], ((g / p.stages) - 1) & 1);
          mbar_expect_tx(&kvfull[s], CH);
          sk_load<D>(skv + s * CH, SK_BOX, &tk, &kvfull[s], h, SK_KEYS * c, b);
          sk_load<D>(skv + s * CH + QT, SK_BOX, &tv, &kvfull[s], h, SK_KEYS * c, b);
          // the next item's q goes where item i - 1's was, once that is released
          if (c == cq && i >= 1 && i + 1 < n) {
            mbar_wait(&qempty[(i + 1) & 1], ((i - 1) >> 1) & 1);
            load_q(i + 1);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw takes tile NW tg + cw of each item. Per chunk c
  // one product batch, P V of chunk c and S of chunk c + 1; the warpgroups
  // issue their batches in turns (named barriers NW + 1 .., round robin),
  // so one's softmax runs beside the others' products. At D 64, S takes Q
  // from registers (ldmatrix from the q tile once per item): two operands
  // from shared memory at N = 64 would need as many bytes a cycle as the
  // SM's shared memory gives. At D 128 that would pass the 168-register
  // cap, and S reads both from shared memory.
  constexpr bool QREG = D == 64;
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128, qd = tid & 3;
  const int turn = NW + 1 + cw, after = NW + 1 + (cw + 1) % NW;
  uint8_t* stg = staging + cw * QT;
  if (cw == NW - 1) named_bar_arrive(NW + 1, 256);  // warpgroup 0 issues first
  int g = 0;
  for (int i = 0; i < n; ++i) {
    const int it = blockIdx.x + i * gridDim.x, pr = it / groups, tg = it % groups;
    mbar_wait(&qfull[i & 1], (i >> 1) & 1);
    uint8_t* qtile = sq + (NW * (i & 1) + cw) * QT;
    const uint64_t dq = sw128_desc(qtile);
    uint32_t qf[4][4];
    if constexpr (QREG) {
      const int lane = tid & 31, mt = lane >> 3;
      const int r = 16 * (tid >> 5) + (lane & 7) + 8 * (mt & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(qf[kk], smem_addr(qtile + sw128_offset(r, 16 * kk + 8 * (mt >> 1), 64)));
      fence_proxy_async();  // generic reads before the stage's next TMA write
      mbar_arrive(&qempty[i & 1]);
    }
    float o[D / 64][32];
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[hf][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float sc[SK_KEYS / 2];
    uint32_t pa[SK_KEYS / 16][4];
    auto logits = [&](int stage) {
      if constexpr (QREG) sk_logits_rs(sc, qf, sw128_desc(skv + stage * CH));
      else sk_logits<D, SK_KEYS>(sc, dq, sw128_desc(skv + stage * CH), SK_BOX);
    };

    mbar_wait(&kvfull[g % p.stages], (g / p.stages) & 1);
    named_bar_sync(turn, 256);
    if constexpr (QREG) fence_regs(qf);
    wgmma_fence();
    logits(g % p.stages);
    wgmma_commit();
    named_bar_arrive(after, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    if (!QREG && nch == 1) mbar_arrive(&qempty[i & 1]);
    sk_online_softmax<D>(sc, pa, o, m, l, 0, nch, p.lk, p.scale, qd);
    for (int c = 0; c < nch; ++c, ++g) {
      const int s = g % p.stages, s1 = (g + 1) % p.stages;
      const bool next = c + 1 < nch;
      if (next) mbar_wait(&kvfull[s1], ((g + 1) / p.stages) & 1);
      named_bar_sync(turn, 256);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) fence_regs(o[hf]);
      fence_regs(pa);
      wgmma_fence();
      sk_pv<D, SK_KEYS>(o, pa, sw128_desc(skv + s * CH + QT), SK_BOX);
      if (next) logits(s1);
      wgmma_commit();
      named_bar_arrive(after, 256);
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) fence_regs(o[hf]);
      fence_regs(pa);  // wgmma reads its register A operand until the wait
      fence_regs(sc);
      if (tid == 0) mbar_arrive(&kvempty[s]);
      if (next) {
        if (!QREG && c + 2 == nch) mbar_arrive(&qempty[i & 1]);  // q's last read
        sk_online_softmax<D>(sc, pa, o, m, l, c + 1, nch, p.lk, p.scale, qd);
      }
    }
    const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
    sk_store<D>(&to, stg, o, inv, pr % p.heads, (NW * tg + cw) * SK_ROWS, pr / p.heads, cw,
                tid);
  }
  if (cw == 0) named_bar_sync(NW + 1, 256);  // the last warpgroup's last turn
  if (tid == 0) bulk_wait<0>();
}

template <auto KERNEL, int THREADS = SK_THREADS>
static cudaError_t launch_sk(const CUtensorMap* maps, const ShortKvArgs& p, dim3 grid, int smem,
                             cudaStream_t s) {
  thread_local int allowed = 0;  // the dynamic shared memory this kernel was allowed so far
  if (smem > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  KERNEL<<<grid, THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_whole(int nk, const CUtensorMap* maps, const ShortKvArgs& p, dim3 grid,
                                cudaStream_t s) {
  const int smem = sk_whole_smem(D, nk, p.stages);
  switch (nk / 16) {
    case 1: return launch_sk<short_kv_tma_kernel<D, 16>>(maps, p, grid, smem, s);
    case 2: return launch_sk<short_kv_tma_kernel<D, 32>>(maps, p, grid, smem, s);
    case 3: return launch_sk<short_kv_tma_kernel<D, 48>>(maps, p, grid, smem, s);
    case 4: return launch_sk<short_kv_tma_kernel<D, 64>>(maps, p, grid, smem, s);
    case 5: return launch_sk<short_kv_tma_kernel<D, 80>>(maps, p, grid, smem, s);
    case 6: return launch_sk<short_kv_tma_kernel<D, 96>>(maps, p, grid, smem, s);
    case 7: return launch_sk<short_kv_tma_kernel<D, 112>>(maps, p, grid, smem, s);
    default: return launch_sk<short_kv_tma_kernel<D, 128>>(maps, p, grid, smem, s);
  }
}

}  // namespace mudg

using namespace mudg;

// q (batch, lq, heads, d), k and v (batch, lk, heads, d) bf16 with the given
// element strides (the head dim contiguous, every stride a multiple of 8,
// 16-byte aligned pointers); o (batch, lq, heads, d) bf16 contiguous. d = 64
// or 128, lq % 128 == 0, 1 <= lk <= 1024. The launch plan
// (kernels/short_attention.short_kv_plan): whole K/V for lk <= 128, with
// `span` q tiles a block and `stages` q tiles in flight, a grid of (tiles /
// span, heads, batch); else streamed, `grid` persistent blocks over `span`
// items (sk_stream_wgs(d) q tiles of one (batch, head) pair) and `stages`
// K|V chunks in flight.
extern "C" int mudg_short_kv_tma(const void* q, const void* k, const void* v, void* o,
                                 int batch, int lq, int lk, int heads, int d, int span,
                                 int stages, int grid, long long q_sb, long long q_sl,
                                 long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                                 long long v_sb, long long v_sl, long long v_sh, void* stream) {
  const bool whole = lk <= 128;
  const int nk = (lk + 15) / 16 * 16;
  if (lk < 1 || lk > 1024 || (d != 64 && d != 128) || lq < 2 * SK_ROWS || lq % (2 * SK_ROWS) ||
      batch < 1 || heads < 1 || span < 1 || stages < 2 || grid < 1 ||
      (whole ? sk_whole_smem(d, nk, stages) : sk_stream_smem(d, stages)) > 232448)
    return cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                            (long long)lq * heads * d, (long long)heads * d, d};
  const int len[4] = {lq, lk, lk, lq};
  const void* base[4] = {q, k, v, o};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e = mudg_host::bf16_heads_map(&maps[i], base[i], batch, len[i], heads, d,
                                                    st[3 * i], st[3 * i + 1], st[3 * i + 2]);
    if (e != cudaSuccess) return e;
  }
  ShortKvArgs p;
  p.lk = lk;
  p.span = span;
  p.tiles = lq / SK_ROWS;
  p.heads = heads;
  p.stages = stages;
  p.scale = 1.4426950408889634f / sqrtf((float)d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (whole) {
    const dim3 g3((p.tiles + span - 1) / span, heads, batch);
    return d == 64 ? launch_whole<64>(nk, maps, p, g3, s) : launch_whole<128>(nk, maps, p, g3, s);
  }
  const int smem = sk_stream_smem(d, stages);
  return d == 64
             ? launch_sk<short_kv_stream_kernel<64>, 128 * sk_stream_wgs(64) + 32>(maps, p, dim3(grid),
                                                                              smem, s)
             : launch_sk<short_kv_stream_kernel<128>, 128 * sk_stream_wgs(128) + 32>(
                   maps, p, dim3(grid), smem, s);
}
