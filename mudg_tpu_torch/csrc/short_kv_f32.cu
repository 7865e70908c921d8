// Kernel 12, short-KV form, fp32: the whole-K/V kernel at head dim 64 and
// Lk <= 128 (every MuDG fp32 site: the text and image cross-attention of an
// fp32 UNet forward, `sample`'s default dtype, under MUDG_SHORT_ATTN=1; Lk
// = 77 and 16), and the chunked kernel below for the rest the predicate
// admits (head dim 128, Lk up to 1024: K and V^T in hi and lo copies would
// take 256 KB of shared memory at D = 128, Lk = 128):
//   o = softmax(q k^T / sqrt(D)) v,  q (B, Lq, H, D) over k, v (B, Lk, H, D),
// fp32 logits scaled after the product (short_attention.py:168-170), keys
// past Lk masked to -inf, an fp32 softmax (normalised before P V by the
// whole-K/V kernel, online over key chunks by the chunked one: P stays fp32,
// so the two orders agree to fp32 rounding). The wrapper picks the kernel
// (kernels/short_attention.short_kv_plan).
//
// Replaces: mudg_tpu/kernels/short_attention.py:_short_kv_kernel
// (short_kv_attention, pallas_call at :214) for fp32 operands.
//
// Bound on this card: bytes. At MDM512 ds1 (32 x 2560 queries, 5 heads, Lk
// = 77) q and o are 210 MB (63 us at 3.35 TB/s) against 8.1 GFLOP of
// products, 49 us as three TF32 products each at 495 TFLOP/s (121 us on
// the FMA units, which the kernel this one replaces used).
//
// Design: fp32 is kept on the tensor cores as flash_attn_f32.cu keeps it:
// every product is three tf32 products, lo_a hi_b + hi_a lo_b + hi_a hi_b,
// the two small terms first, with x = hi + lo, hi = tf32(x) and lo = tf32(x
// - hi) (cvt.rna). One block of three warpgroups per SM walks a span of
// consecutive 64-row q tiles in (batch, head, tile) order.
// - Warpgroup 0 is the producer (setmaxnreg 24). For each (batch, head)
//   pair its span reaches, one thread loads the pair's raw K and V by TMA
//   through 4-D maps (64, H, Lk, B) (k and v may be strided views of one
//   k|v buffer; the rows from Lk up to NK, Lk rounded up to 16, arrive as
//   zeros), then streams the pair's q tiles through a ring of raw fp32 q
//   tiles (two 32-column boxes each).
// - Warpgroups 1 and 2 (setmaxnreg 240) first split the pair's K and V
//   once, together: K's hi and lo copies keep its layout (K-major for S =
//   Q K^T: rows the keys, K the head dims); V is transposed into hi and lo
//   copies of V^T (K-major for P V: rows the head dims, K the keys), each
//   8-key group stored in the order [0, 2, 4, 6, 1, 3, 5, 7], the order in
//   which an fp32 accumulator's columns are a tf32 A fragment (tf32_frag).
//   The raw area is then free for the next pair's loads.
// - Then they take alternate q tiles: each thread reads its A fragments
//   of the raw q tile from shared memory and splits them in registers (no
//   split pass through device memory: a second copy of q would double the
//   bytes this bytes-bound kernel moves; the stage is released once S is
//   done), S = Q K^T by 3 x 8 wgmma
//   m64nNKk8 with A from registers, the logits scaled and masked in fp32,
//   the softmax there, P split in registers, and O = P V by 3 wgmma
//   m64n64k8 per 8 keys, each 64-key chunk's product in an accumulator of
//   its own added in fp32 (the tensor core rounds its sums toward zero:
//   flash_attn_f32.cu). O leaves from registers as float2 stores, each
//   warp instruction eight whole 32-byte sectors.
// Shared memory: K and V^T hi and lo (NK * 1 KB), the raw K and V (NK *
// 512 B) and the q ring (4 stages, 2 from NK = 112): 192 KB at NK = 80,
// 226 KB at NK = 128.
#include "hopper.cuh"

namespace mudg {

constexpr int SF_THREADS = 384;            // producer warpgroup + two consumer warpgroups
constexpr int SF_ROWS = 64;                // query rows per tile (one warpgroup)
constexpr int SF_QTILE = SF_ROWS * 64 * 4;  // bytes of a raw fp32 q tile

__host__ __device__ constexpr int sf_stages(int nk) { return nk <= 96 ? 4 : 2; }
// bytes of one copy (hi or lo) of K: two 32-column boxes of nk rows
__host__ __device__ constexpr int sf_k_bytes(int nk) { return nk * 256; }
// bytes of one copy of V^T: boxes of 64 head-dim rows by 32 keys
__host__ __device__ constexpr int sf_vt_bytes(int nk) { return (nk + 31) / 32 * 8192; }
__host__ __device__ constexpr int sf_smem(int nk) {
  return 1024 + 2 * sf_k_bytes(nk) + 2 * sf_vt_bytes(nk) + 2 * sf_k_bytes(nk) +
         sf_stages(nk) * SF_QTILE + 256;
}

struct ShortKvF32Args {
  float* o;            // (batch, lq, heads, 64) contiguous
  int total;           // q tiles in all: batch * heads * tiles
  int span;            // consecutive tiles per block
  int lq, lk, heads;
  int tiles;           // q tiles per (batch, head)
  float scale;         // d^-0.5 * log2(e): logits in base 2, scaled in fp32
};

// The byte offset of fp32 element (r, c) of a tile of 32-column boxes, each
// `rows` rows of 128 bytes under the 128-byte swizzle.
__device__ __forceinline__ uint32_t sw128_f32_offset(int r, int c, int rows) {
  return (uint32_t)((c >> 5) * rows * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) +
                    (c & 3) * 4);
}

// Where key k of an 8-group sits in V^T's copies: keys 0, 2, 4, 6 at
// positions 0-3, keys 1, 3, 5, 7 at 4-7.
__device__ __forceinline__ int perm8_pos(int k) { return (k & 1) ? 4 + (k >> 1) : k >> 1; }

// The pair's raw K and V (NK rows each, two 32-column boxes) split into
// K hi | K lo | V^T hi | V^T lo by the 256 consumer threads (ct = 0..255).
template <int NK>
__device__ __forceinline__ void sf_split_kv(uint8_t* sm, const uint8_t* rawk, const uint8_t* rawv,
                                            int ct) {
  constexpr int KB = sf_k_bytes(NK), VB = sf_vt_bytes(NK);
  uint8_t* khi = sm;
  uint8_t* vthi = sm + 2 * KB;
  // K: the raw tile's 16-byte chunks in place (the same layout)
  for (int i = ct; i < KB / 16; i += 256) {
    const float4 x = *reinterpret_cast<const float4*>(rawk + 16 * i);
    uint32_t hi[4], lo[4];
    tf32_split(x.x, hi[0], lo[0]);
    tf32_split(x.y, hi[1], lo[1]);
    tf32_split(x.z, hi[2], lo[2]);
    tf32_split(x.w, hi[3], lo[3]);
    *reinterpret_cast<uint4*>(khi + 16 * i) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(khi + KB + 16 * i) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  // V^T: item i is key i % NK, head dims 4 (i / NK) .. + 3; a warp's lanes
  // take consecutive keys, so each store fills one 128-byte row
  for (int i = ct; i < NK * 16; i += 256) {
    const int key = i % NK, d0 = 4 * (i / NK);
    const float4 x = *reinterpret_cast<const float4*>(rawv + sw128_f32_offset(key, d0, NK));
    const int col = (key & 31 & ~7) | perm8_pos(key & 7);
    const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi, lo;
      tf32_split(e[j], hi, lo);
      const uint32_t off = (key >> 5) * 8192 + sw128_f32_offset(d0 + j, col, 64);
      *reinterpret_cast<uint32_t*>(vthi + off) = hi;
      *reinterpret_cast<uint32_t*>(vthi + VB + off) = lo;
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(SF_THREADS, 1)
    short_kv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const ShortKvF32Args p) {
  constexpr int S = sf_stages(NK), KB = sf_k_bytes(NK), VB = sf_vt_bytes(NK);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);          // K hi, K lo, V^T hi, V^T lo
  uint8_t* rawk = sm + 2 * KB + 2 * VB;       // raw K, then raw V (NK rows each)
  uint8_t* rawv = rawk + KB;
  uint8_t* ring = rawv + KB;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * SF_QTILE);
  uint64_t* empty = full + S;
  uint64_t* kv_full = empty + S;
  uint64_t* kv_free = kv_full + 1;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  // 32-bit tile arithmetic: the producer warpgroup runs on 24 registers
  const int t0 = blockIdx.x * p.span, t1 = min(t0 + p.span, p.total);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);   // tile i and stage i % S belong to warpgroup i % 2
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_free, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      int i = 0, seg = 0;
      for (int t = t0; t < t1; ++seg) {
        const int pair = t / p.tiles, end = min((pair + 1) * p.tiles, t1);
        const int h = pair % p.heads, b = pair / p.heads;
        if (seg > 0) mbar_wait(kv_free, (seg - 1) & 1);   // the last pair is split
        mbar_expect_tx(kv_full, 2 * KB);
        for (int cb = 0; cb < 2; ++cb) {
          tma_load_4d(rawk + cb * NK * 128, &tk, kv_full, 32 * cb, h, 0, b);
          tma_load_4d(rawv + cb * NK * 128, &tv, kv_full, 32 * cb, h, 0, b);
        }
        for (; t < end; ++t, ++i) {
          const int s = i % S, row = (t - pair * p.tiles) * SF_ROWS;
          if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
          uint8_t* st = ring + s * SF_QTILE;
          mbar_expect_tx(&full[s], SF_QTILE);
          for (int cb = 0; cb < 2; ++cb)
            tma_load_4d(st + cb * SF_QTILE / 2, &tq, &full[s], 32 * cb, h, row, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw takes the block's tiles i = cw, cw + 2, ..
  setmaxnreg_inc<240>();
  const int cw = wg - 1, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const uint64_t dk_hi = sw128_desc(sm), dk_lo = sw128_desc(sm + KB);
  const uint64_t dv_hi = sw128_desc(sm + 2 * KB), dv_lo = sw128_desc(sm + 2 * KB + VB);
  int i = 0, seg = 0;
  for (int t = t0; t < t1; ++seg) {
    const int pair = t / p.tiles, end = min((pair + 1) * p.tiles, t1);
    const int h = pair % p.heads, b = pair / p.heads;
    // every consumer is done with the last pair's copies (each tile waits
    // for its products), then both warpgroups split this pair's
    named_bar_sync(1, 256);
    mbar_wait(kv_full, seg & 1);
    sf_split_kv<NK>(sm, rawk, rawv, threadIdx.x - 128);
    fence_proxy_async();   // the copies are read by wgmma (the async proxy)
    named_bar_sync(1, 256);
    if (threadIdx.x == 128) mbar_arrive(kv_free);
    for (; t < end; ++t, ++i) {
      if ((i & 1) != cw) continue;
      const int s = i % S;
      mbar_wait(&full[s], (i / S) & 1);
      // Q's A fragments, split in registers: k8 step kk holds head dims 8 kk
      // + qd (a0, a1) and 8 kk + qd + 4 (a2, a3) of rows r and r + 8
      const uint8_t* qt = ring + s * SF_QTILE;
      const int r = 16 * warp + g;
      uint32_t qh[8][4], ql[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int c = 8 * kk + qd;
        tf32_split(*reinterpret_cast<const float*>(qt + sw128_f32_offset(r, c, 64)), qh[kk][0],
                   ql[kk][0]);
        tf32_split(*reinterpret_cast<const float*>(qt + sw128_f32_offset(r + 8, c, 64)),
                   qh[kk][1], ql[kk][1]);
        tf32_split(*reinterpret_cast<const float*>(qt + sw128_f32_offset(r, c + 4, 64)),
                   qh[kk][2], ql[kk][2]);
        tf32_split(*reinterpret_cast<const float*>(qt + sw128_f32_offset(r + 8, c + 4, 64)),
                   qh[kk][3], ql[kk][3]);
      }

      float sc[NK / 2];
      fence_regs(qh);
      fence_regs(ql);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_tf32_rs<NK>(sc, ql[kk], dk_hi + tf32_kstep<NK>(kk), kk);
        wgmma_tf32_rs<NK>(sc, qh[kk], dk_lo + tf32_kstep<NK>(kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_tf32_rs<NK>(sc, qh[kk], dk_hi + tf32_kstep<NK>(kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(qh);
      fence_regs(ql);
      // the stage is free once the q values it held are consumed, and behind
      // a proxy fence: the refill is an async-proxy (TMA) write after this
      // thread's generic reads (released straight after the loads, a refill
      // overtook them about once in twelve calls at Lk = 16)
      fence_proxy_async();
      mbar_arrive(&empty[s]);

      // softmax over the Lk keys of rows g and g + 8 of this warp's 16
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < NK / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[4 * jj + 2 * hh + e];
            v = 8 * jj + 2 * qd + e < p.lk ? v * p.scale : -INFINITY;
            mx = fmaxf(mx, v);
          }
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

      // O = P V: keys 0-63, then 64 .. NK - 1, each in an accumulator of its own
      constexpr int KS = NK / 8, KS0 = KS < 8 ? KS : 8;
      float o[32];
      {
        uint32_t ph[KS0][4], pl[KS0][4];
#pragma unroll
        for (int j = 0; j < KS0; ++j) tf32_frag(ph[j], pl[j], sc, j);
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
        mma3_rs<KS0>(o, ph, pl, dv_hi, dv_lo);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(ph);
        fence_regs(pl);
      }
      if constexpr (KS > 8) {
        constexpr int KS1 = KS - 8;
        uint32_t ph[KS1][4], pl[KS1][4];
#pragma unroll
        for (int j = 0; j < KS1; ++j) tf32_frag(ph[j], pl[j], sc, 8 + j);
        float pv[32];
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
        mma3_rs<KS1>(pv, ph, pl, dv_hi + (16384 >> 4), dv_lo + (16384 >> 4));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(ph);
        fence_regs(pl);
        const float one[2] = {1.f, 1.f};
        add_tile(o, pv, one);
      }

      // rows r and r + 8 of the tile, head dims 8 j + 2 qd, + 1
      const int q0 = (t - pair * p.tiles) * SF_ROWS + r;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* orow = p.o + (((size_t)b * p.lq + q0 + 8 * hh) * p.heads + h) * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(orow + 8 * j + 2 * qd) =
              make_float2(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
      }
    }
  }
}

template <int NK>
static cudaError_t launch_short_kv_tf32(const CUtensorMap& tq, const CUtensorMap& tk,
                                        const CUtensorMap& tv, const ShortKvF32Args& p,
                                        int grid, cudaStream_t s) {
  thread_local bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(short_kv_tf32_kernel<NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sf_smem(NK));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  short_kv_tf32_kernel<NK><<<grid, SF_THREADS, sf_smem(NK), s>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace mudg

namespace mudg_host {

// A tensor map over a (batch, seq, heads, d) fp32 tensor with element
// strides sb, sl, sh (head dim contiguous), as dims (d, heads, seq, batch)
// with boxes of 32 head dims by `rows` sequence rows of one head; rows past
// seq read as zeros.
static inline cudaError_t f32_rows_map(CUtensorMap* map, const void* base, int batch, int seq,
                                       int heads, long long sb, long long sl, long long sh,
                                       int rows, int d = 64) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 4, (cuuint64_t)sl * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 4, dims, strides, box);
}

}  // namespace mudg_host

using namespace mudg;

// q (batch, lq, heads, 64), k and v (batch, lk, heads, 64) fp32 with the
// given element strides (the head dim contiguous, every stride a multiple
// of 4, 16-byte aligned pointers); o (batch, lq, heads, 64) fp32
// contiguous. lq % 64 == 0, 1 <= lk <= 128, d == 64.
extern "C" int mudg_short_kv_tf32(const void* q, const void* k, const void* v, void* o,
                                  int batch, int lq, int lk, int heads, int d,
                                  long long q_sb, long long q_sl, long long q_sh,
                                  long long k_sb, long long k_sl, long long k_sh,
                                  long long v_sb, long long v_sl, long long v_sh,
                                  void* stream) {
  if (lk < 1 || lk > 128 || d != 64 || lq < SF_ROWS || lq % SF_ROWS || batch < 1 || heads < 1 ||
      (long long)batch * heads * (lq / SF_ROWS) > (1LL << 30))
    return cudaErrorInvalidValue;
  const int sms = mudg_host::sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int nk = (lk + 15) / 16 * 16;
  using mudg_host::f32_rows_map;
  CUtensorMap tq, tk, tv;
  cudaError_t e = f32_rows_map(&tq, q, batch, lq, heads, q_sb, q_sl, q_sh, SF_ROWS);
  if (e == cudaSuccess) e = f32_rows_map(&tk, k, batch, lk, heads, k_sb, k_sl, k_sh, nk);
  if (e == cudaSuccess) e = f32_rows_map(&tv, v, batch, lk, heads, v_sb, v_sl, v_sh, nk);
  if (e != cudaSuccess) return e;
  ShortKvF32Args p;
  p.o = static_cast<float*>(o);
  p.lq = lq;
  p.lk = lk;
  p.heads = heads;
  p.tiles = lq / SF_ROWS;
  p.total = batch * heads * p.tiles;
  // one block per SM, each a span of consecutive tiles: a span crosses at
  // most a few (batch, head) pairs, so K and V are split a few times a block
  p.span = (p.total + sms - 1) / sms;
  p.scale = 0.125f * 1.4426950408889634f;
  const int grid = (p.total + p.span - 1) / p.span;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nk / 16) {
    case 1: return launch_short_kv_tf32<16>(tq, tk, tv, p, grid, s);
    case 2: return launch_short_kv_tf32<32>(tq, tk, tv, p, grid, s);
    case 3: return launch_short_kv_tf32<48>(tq, tk, tv, p, grid, s);
    case 4: return launch_short_kv_tf32<64>(tq, tk, tv, p, grid, s);
    case 5: return launch_short_kv_tf32<80>(tq, tk, tv, p, grid, s);
    case 6: return launch_short_kv_tf32<96>(tq, tk, tv, p, grid, s);
    case 7: return launch_short_kv_tf32<112>(tq, tk, tv, p, grid, s);
    default: return launch_short_kv_tf32<128>(tq, tk, tv, p, grid, s);
  }
}

namespace mudg {

// ---- chunked K/V: head dim 128, or Lk > 128 --------------------------------
//
// The same function and the same three tf32 products per product, for
// what the layout above cannot hold (K and V^T in hi and lo copies take NK
// * 1 KB at D 64 and twice that at D 128). One persistent block of two
// warpgroups per SM walks items of two consecutive q tiles of one (batch,
// head) pair, a tile a warpgroup, and both walk the pair's keys in chunks
// of SC_KEYS(D) keys (64 at D 64, 32 at D 128):
// - Each warpgroup splits its raw q tile (TMA, 32-column boxes) in place
//   into hi, and lo into a copy of its own, once per item: at D 128 q's
//   fragments in registers (128 a thread, hi and lo) would not fit beside
//   O, so S takes both operands from shared memory (wgmma_tf32_ss).
// - Per chunk, thread 0 has loaded the raw K and V chunk by TMA (rows past
//   Lk arrive as zeros); all 256 threads split it, as it lands, into K hi
//   and lo and V^T hi and lo (perm8 key order), and thread 0 loads the next
//   chunk into the raw area. S = Q K^T is 3 x D / 8 wgmma m64nCk8, the
//   logits scaled in fp32, keys past Lk masked, an online softmax in fp32
//   (running max and sum), P split in registers, and each chunk's P V, 3 x
//   C / 8 wgmma m64n64k8 per 64 head dims, goes to an accumulator of its own
//   that is added to O in fp32 with O's rescaling (add_tile): one
//   accumulator over many keys misses 1e-5 (flash_attn_f32.cu).
// - O leaves from registers as float2 stores.
// The split and the loads are not overlapped with the products beyond the
// next chunk's raw load (shared memory holds no second split area at D 128:
// q 128 KB, one split chunk 64 KB, one raw chunk 32 KB).

constexpr int SC_THREADS = 256;  // two warpgroups
__host__ __device__ constexpr int sc_keys(int d) { return d == 64 ? 64 : 32; }
__host__ __device__ constexpr int sc_smem(int d) {
  return 1024 + 4 * SF_ROWS * d * 4 + 6 * sc_keys(d) * d * 4 + 16;
}

struct ShortKvF32ChunkArgs {
  float* o;    // (batch, lq, heads, d) contiguous
  int items;   // (batch, head, tile pair) items in all
  int lq, lk, heads;
  int tiles;   // q tiles per (batch, head)
  float scale; // d^-0.5 * log2(e)
};

// Split the raw chunk (C keys of K and V, D / 32 column boxes of C rows)
// into K hi | K lo (the raw layout) and V^T hi | V^T lo (per 64 head dims,
// C / 32 boxes of 64 rows by 32 keys in perm8 order), by the 256 threads.
template <int D, int C>
__device__ __forceinline__ void sc_split_kv(uint8_t* split, const uint8_t* rawk,
                                            const uint8_t* rawv, int t) {
  constexpr int KB = C * D * 4;  // bytes of one copy
  uint8_t* khi = split;
  uint8_t* vthi = split + 2 * KB;
  for (int i = t; i < KB / 16; i += SC_THREADS) {
    const float4 x = *reinterpret_cast<const float4*>(rawk + 16 * i);
    uint32_t hi[4], lo[4];
    tf32_split(x.x, hi[0], lo[0]);
    tf32_split(x.y, hi[1], lo[1]);
    tf32_split(x.z, hi[2], lo[2]);
    tf32_split(x.w, hi[3], lo[3]);
    *reinterpret_cast<uint4*>(khi + 16 * i) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(khi + KB + 16 * i) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  // item i: key i % C, head dims 4 (i / C) .. + 3; a warp's lanes take
  // consecutive keys
  for (int i = t; i < C * D / 4; i += SC_THREADS) {
    const int key = i % C, d0 = 4 * (i / C);
    const float4 x = *reinterpret_cast<const float4*>(rawv + sw128_f32_offset(key, d0, C));
    const int col = (key & 24) | perm8_pos(key & 7);
    const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi, lo;
      tf32_split(e[j], hi, lo);
      const int dd = d0 + j;
      const uint32_t off = ((dd >> 6) * (C / 32) + (key >> 5)) * 8192 +
                           sw128_f32_offset(dd & 63, col, 64);
      *reinterpret_cast<uint32_t*>(vthi + off) = hi;
      *reinterpret_cast<uint32_t*>(vthi + KB + off) = lo;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(SC_THREADS, 1)
    short_kv_tf32_chunk_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const ShortKvF32ChunkArgs p) {
  constexpr int C = sc_keys(D), QB = SF_ROWS * D * 4, KB = C * D * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);  // per warpgroup: q hi (the raw tile, split in place), q lo
  uint8_t* split = sq + 4 * QB;       // K hi, K lo, V^T hi, V^T lo
  uint8_t* rawk = split + 4 * KB;
  uint8_t* rawv = rawk + KB;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(rawv + KB);
  uint64_t* rawbar = qbar + 1;
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int nch = (p.lk + C - 1) / C, pairs = p.tiles / 2;
  const int n = p.items > (int)blockIdx.x ? (p.items - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  auto load_q = [&](int i) {  // item i's two raw q tiles
    const int it = blockIdx.x + i * gridDim.x, pr = it / pairs, tp = it % pairs;
    mbar_expect_tx(qbar, 2 * QB);
    for (int w = 0; w < 2; ++w)
      for (int cb = 0; cb < D / 32; ++cb)
        tma_load_4d(sq + 2 * w * QB + cb * SF_ROWS * 128, &tq, qbar, 32 * cb, pr % p.heads,
                    (2 * tp + w) * SF_ROWS, pr / p.heads);
  };
  auto load_chunk = [&](int i, int c) {  // chunk c of item i's pair
    const int pr = (blockIdx.x + i * gridDim.x) / pairs;
    mbar_expect_tx(rawbar, 2 * KB);
    for (int cb = 0; cb < D / 32; ++cb) {
      tma_load_4d(rawk + cb * C * 128, &tk, rawbar, 32 * cb, pr % p.heads, C * c, pr / p.heads);
      tma_load_4d(rawv + cb * C * 128, &tv, rawbar, 32 * cb, pr % p.heads, C * c, pr / p.heads);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    mbar_init(rawbar, 1);
    mbar_init_fence();
    if (n > 0) {
      load_q(0);
      load_chunk(0, 0);
    }
  }
  __syncthreads();

  uint8_t* qhi = sq + 2 * cw * QB;
  uint8_t* qlo = qhi + QB;
  const uint64_t dqh = sw128_desc(qhi), dql = sw128_desc(qlo);
  const uint64_t dkh = sw128_desc(split), dkl = sw128_desc(split + KB);
  const uint64_t dvh = sw128_desc(split + 2 * KB), dvl = sw128_desc(split + 3 * KB);
  int rc = 0;  // chunks loaded so far (rawbar's phase)
  for (int i = 0; i < n; ++i) {
    const int it = blockIdx.x + i * gridDim.x, pr = it / pairs, tp = it % pairs;
    mbar_wait(qbar, i & 1);
    for (int j = tid; j < QB / 16; j += 128) {  // this warpgroup's tile: hi in place, lo
      const float4 x = *reinterpret_cast<const float4*>(qhi + 16 * j);
      uint32_t hi[4], lo[4];
      tf32_split(x.x, hi[0], lo[0]);
      tf32_split(x.y, hi[1], lo[1]);
      tf32_split(x.z, hi[2], lo[2]);
      tf32_split(x.w, hi[3], lo[3]);
      *reinterpret_cast<uint4*>(qhi + 16 * j) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(qlo + 16 * j) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_proxy_async();  // read by wgmma
    float o[D / 64][32];
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[hf][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int c = 0; c < nch; ++c, ++rc) {
      mbar_wait(rawbar, rc & 1);
      sc_split_kv<D, C>(split, rawk, rawv, threadIdx.x);
      fence_proxy_async();  // the copies are read by wgmma, the raw area refilled by TMA
      named_bar_sync(1, SC_THREADS);
      if (threadIdx.x == 0) {  // the next chunk, of this item or the next
        if (c + 1 < nch) load_chunk(i, c + 1);
        else if (i + 1 < n) load_chunk(i + 1, 0);
      }
      float sc[C / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        wgmma_tf32_ss<C>(sc, dql + tf32_kstep<SF_ROWS>(kk), dkh + tf32_kstep<C>(kk), kk);
        wgmma_tf32_ss<C>(sc, dqh + tf32_kstep<SF_ROWS>(kk), dkl + tf32_kstep<C>(kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        wgmma_tf32_ss<C>(sc, dqh + tf32_kstep<SF_ROWS>(kk), dkh + tf32_kstep<C>(kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax of rows g and g + 8 over this chunk's keys, in fp32
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int jj = 0; jj < C / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[4 * jj + 2 * hh + e];
            v = C * c + 8 * jj + 2 * qd + e < p.lk ? v * p.scale : -INFINITY;
            mx = fmaxf(mx, v);
          }
        mx = quad_max(mx);
        alpha[hh] = exp2f(m[hh] - mx);  // 0 on the first chunk
        m[hh] = mx;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < C / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[4 * jj + 2 * hh + e];
            v = exp2f(v - mx);
            sum += v;
          }
        l[hh] = l[hh] * alpha[hh] + sum;
      }
      // O = alpha O + P V, P V per 64 head dims in an accumulator of its own
      uint32_t ph[C / 8][4], pl[C / 8][4];
#pragma unroll
      for (int j = 0; j < C / 8; ++j) tf32_frag(ph[j], pl[j], sc, j);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) {
        float pv[32];
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
        mma3_rs<C / 8>(pv, ph, pl, dvh + hf * ((C / 32) * 8192 >> 4),
                       dvl + hf * ((C / 32) * 8192 >> 4));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(ph);
        fence_regs(pl);
        add_tile(o[hf], pv, alpha);
      }
      named_bar_sync(1, SC_THREADS);  // both warpgroups are done with the split chunk
    }
    if (threadIdx.x == 0 && i + 1 < n) load_q(i + 1);  // every S of this item is done

    // rows r and r + 8 of the tile, head dims 8 j + 2 qd, + 1 of each 64
    const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
    const int q0 = (2 * tp + cw) * SF_ROWS + 16 * warp + g, b = pr / p.heads, h = pr % p.heads;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (q0 + 8 * hh >= p.lq) continue;
      float* orow = p.o + (((size_t)b * p.lq + q0 + 8 * hh) * p.heads + h) * D;
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(orow + 64 * hf + 8 * j + 2 * qd) =
              make_float2(o[hf][4 * j + 2 * hh] * inv[hh], o[hf][4 * j + 2 * hh + 1] * inv[hh]);
    }
  }
}

template <int D>
static cudaError_t launch_tf32_chunks(const CUtensorMap* maps, const ShortKvF32ChunkArgs& p,
                                      int grid, cudaStream_t s) {
  thread_local bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        short_kv_tf32_chunk_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, sc_smem(D));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  short_kv_tf32_chunk_kernel<D><<<grid, SC_THREADS, sc_smem(D), s>>>(maps[0], maps[1], maps[2],
                                                                      p);
  return cudaGetLastError();
}

}  // namespace mudg

// As mudg_short_kv_tf32 at head dim 64 or 128 and 1 <= lk <= 1024 (lq %
// 128 == 0): the chunked kernel, `grid` persistent blocks
// (kernels/short_attention.short_kv_plan).
extern "C" int mudg_short_kv_tf32_chunked(const void* q, const void* k, const void* v, void* o,
                                          int batch, int lq, int lk, int heads, int d, int grid,
                                          long long q_sb, long long q_sl, long long q_sh,
                                          long long k_sb, long long k_sl, long long k_sh,
                                          long long v_sb, long long v_sl, long long v_sh,
                                          void* stream) {
  if (lk < 1 || lk > 1024 || (d != 64 && d != 128) || lq < 2 * SF_ROWS || lq % (2 * SF_ROWS) ||
      batch < 1 || heads < 1 || grid < 1 ||
      (long long)batch * heads * (lq / SF_ROWS) > (1LL << 30))
    return cudaErrorInvalidValue;
  const int c = sc_keys(d);
  using mudg_host::f32_rows_map;
  CUtensorMap maps[3];
  cudaError_t e = f32_rows_map(&maps[0], q, batch, lq, heads, q_sb, q_sl, q_sh, SF_ROWS, d);
  if (e == cudaSuccess) e = f32_rows_map(&maps[1], k, batch, lk, heads, k_sb, k_sl, k_sh, c, d);
  if (e == cudaSuccess) e = f32_rows_map(&maps[2], v, batch, lk, heads, v_sb, v_sl, v_sh, c, d);
  if (e != cudaSuccess) return e;
  ShortKvF32ChunkArgs p;
  p.o = static_cast<float*>(o);
  p.lq = lq;
  p.lk = lk;
  p.heads = heads;
  p.tiles = lq / SF_ROWS;
  p.items = batch * heads * (p.tiles / 2);
  p.scale = 1.4426950408889634f / sqrtf((float)d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_tf32_chunks<64>(maps, p, grid, s)
                 : launch_tf32_chunks<128>(maps, p, grid, s);
}
