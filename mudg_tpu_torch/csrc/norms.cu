// Kernel 11: GroupNorm over a channels-last (N, rows, C) tensor and LayerNorm
// over the last axis of (rows, C), bf16 or fp32 in and out, w and b in bf16
// or fp32 as stored, fp32 statistics with the centered variance:
//   GN: y[n, r, c] = (x - mean[n, g(c)]) * rsqrt(var[n, g(c)] + eps) * w[c] + b[c]
//       over the rows x (C / G) elements of each (sample, group);
//   LN: y[r, c]    = (x - mean[r]) * rsqrt(var[r] + eps) * w[c] + b[c].
//
// Replaces: mudg_tpu/kernels/norms.py:_gn_kernel (fused_group_norm,
// pallas_call at :87) and _ln_kernel (fused_layer_norm, :172).
//
// Bound on this card: bytes. A GN or LN reads x once and writes y once at
// about one operation per byte, far below the 295 bf16 operations per byte
// where the tensor cores would bind; e.g. an MDM512 ds1 ResBlock GN
// (32 x 2560 x 320 bf16) moves 105 MB, 31 us at 3.35 TB/s. So the design
// reads x from device memory once and keeps every SM's loads in flight.
//
// GroupNorm, one launch (gn_cluster_kernel). The TPU kernel keeps one sample
// in VMEM; here a thread-block cluster of `cs` CTAs (1..16, 9..16 as a
// non-portable size) takes one sample, each CTA a slab of `per`
// consecutive rows of which it holds the first `keep` in shared memory:
//   1. one thread copies those rows in with GN_PIECES bulk copies
//      (cp.async.bulk), each counted on its own mbarrier, so the statistics
//      of the first rows start while the last ones arrive: x's one read.
//      The shifts, w and b are loaded while the copies fly, and the rows
//      past `keep` are read from device memory;
//   2. each thread owns 8 adjacent channels (one 16-byte chunk of a row in
//      bf16, two in fp32) and walks every k-th row of the slab with a
//      Welford update of x - K, K the sample's first element of the
//      channel's group (row 0, which every CTA reads), then merges its 8
//      channels into at most two group partials (C / G >= 8); the block's
//      full warps merge the partials of each group, several groups a warp
//      (lanes over the group's contributors in a fixed order, then a
//      butterfly of Chan merges over the group's segment of lanes);
//   3. after a cluster barrier a group's segment of lanes reads the cs
//      ranks' partials from the cluster's shared memory at once (mapa,
//      ld.shared::cluster) and merges them in rank order, so every CTA, and
//      every rerun, holds the same bits; a second barrier, waited for just
//      before the CTA exits, keeps each CTA's partials alive until the
//      others have read them;
//   4. it normalises its slab and writes y with 16-byte stores: the rows
//      past `keep` read again first (from L2, microseconds after their first
//      read), then the rows in shared memory. No global scratch, no atomics.
// A block is C / 8 x max(1, 256 / (C / 8)) threads, built for two blocks an
// SM (128 registers). With one block an SM the card holds one cluster of
// more than 8 CTAs a GPC (cudaOccupancyMaxActiveClusters: 7 at once), and
// a large sample runs in waves whose loads, merges and stores do not
// overlap; holding only what lets two CTAs share an SM (`keep`) holds 32
// clusters of 7 at once, and the re-read rows come from L2. The host
// planner (kernels/norms.py:gn_plan) takes each size with all rows held
// (where that fits 227 KB) and with two CTAs an SM, and picks by the
// fewest waves of clusters, then the most CTAs in flight up to 88, then
// the fewest rows read again, then the smallest size.
//
// GroupNorm, two passes (gn_stats_kernel, gn_apply_kernel), where no
// cluster holds a sample: kernel 4's clips (13.1M bf16 elements a sample
// at MDM512 ds1, 47M at MDM1024; two samples are 52 MB, more than the 50 MB
// L2, so keeping part of a sample and re-reading the rest would read it
// from device memory anyway) and fp32 samples above about 0.9M elements.
// The planner decides by shape before the launch:
//   1. gn_stats, one block per (chunk, sample), up to GN_MAX_CHUNKS = 128
//      chunks a sample (kernels/norms.py): the Welford walk of step 2 over
//      the chunk's rows in device memory, four rows in flight (one read of
//      x); a warp per channel group merges the block's row slots and
//      channels, one (mean, M2) partial per (sample, chunk, group) into the
//      caller's scratch;
//   2. gn_apply, one block per (chunk, sample): a warp per group merges the
//      sample's chunk partials (lanes over chunks in a fixed order, then a
//      butterfly), then normalises its rows (a second read of x, one write).
// Every sum of both paths is taken in an order fixed by the shape, so
// reruns are bit for bit. The Welford / Chan merges keep the centered
// form; the Pallas kernel's E[x^2] - E[x]^2 (norms.py:62-68) cancels under
// a DC offset. A mean near 1e3 held in fp32 is off by up to half an ulp
// (3e-5), a mean of x - K is not, and (x - K) - mean' keeps the output's
// error at fp32 rounding of O(std). The merges divide by __fdividef and the
// Welford step by __frcp_rn: IEEE division's slow path spilled.
//
// LayerNorm, two kernels; ln_plan picks by shape before the launch, for
// the Python wrapper and for kernels 1, 2, 3 and 9 alike:
//   - ln_row_kernel, one warp per row and 8 rows a block, the row's 16-byte
//     vectors (8 bf16 or 8 fp32) in registers, lane l holding vectors l,
//     l + 32, .. (a power of two of them a lane); loads straight from
//     device memory, two shuffle reductions, stores;
//   - ln_tile_kernel, a persistent grid (the SM count times the blocks that
//     fit an SM, up to three of 256 threads) walking tiles of consecutive
//     rows, about 24 KB each; one thread keeps LN_STAGES tiles (3) in
//     flight by bulk copies into a ring of shared memory, issued before the
//     block loads w and b, so the next tiles' loads overlap this tile's
//     reductions and stores. A row's 16-byte chunks spread over a team of
//     `team` lanes (a power of two up to 32 dividing the chunk count: every
//     lane works at C = 1280 bf16, 160 chunks on 32 lanes), `vpt` chunks a
//     lane in registers (at most 40 values; wider rows are read from the
//     tile in each of the three passes); w and b sit in shared memory as
//     fp32.
// Both sum a row in a fixed order (each lane in order, then a butterfly):
// the mean, then the centered variance, as _ln_kernel (:148-155), the same
// bits on every rerun. Side by side on an H100 (chip_smoke.py phase 11,
// device time per launch from CUDA graphs; PERF.md), in bf16 at C = 1280
// the tile kernel is about 10% faster at the tables' two shapes of 18432
// rows (39 against 44 us), the two are within 3% of each other at
// 2560-5120 rows, and the row kernel is 20-30% faster at 1280 rows or
// fewer; at C <= 1024 the row kernel is 5-30% faster at every shape, and
// in fp32 it is faster or within 3%: one warp a row keeps more loads in
// flight there than tiles in shared memory do. So ln_plan takes the tile
// kernel in bf16 from C = 1280 and LN_TILE_MIN_BYTES of x (between 13 MB
// and 47 MB), the row kernel
// elsewhere. Loads and stores are 16-byte chunks, so C % 8 == 0.
#include "hopper.cuh"

namespace mudg {

constexpr int GN_PIECES = 8;     // bulk copies (and mbarriers) per GN slab
constexpr int GN_MAX_CLUSTER = 16;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr int LN_STAGES = 3;     // tiles in flight per LN block
constexpr int LN_THREADS = 256;  // most threads of an LN block
constexpr int LN_TILE_BYTES = 24576;
constexpr long long LN_TILE_MIN_BYTES = 24ll << 20;   // the least x the tile kernel takes

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// One 16-byte chunk: 8 bf16 or 4 fp32 values.
template <typename T>
struct Chunk {
  static constexpr int E = 16 / sizeof(T);
};

__device__ __forceinline__ void load_chunk(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = unpack_bf16x2(w[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load_chunk(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void store_chunk(bf16* p, const float v[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = pack_bf16x2(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store_chunk(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Eight channels of a GroupNorm thread: one 16-byte chunk in bf16, two in
// fp32 (a thread per 8 channels keeps a GN block within 512 threads at C =
// 4096, so its registers within 128).
constexpr int GN_E = 8;

__device__ __forceinline__ void load8(const bf16* p, float v[8]) { load_chunk(p, v); }

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  load_chunk(p, v);
  load_chunk(p + 4, v + 4);
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) { store_chunk(p, v); }

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  store_chunk(p, v);
  store_chunk(p + 4, v + 4);
}

// Element i of a weight vector stored as bf16 (wbf) or fp32.
__device__ __forceinline__ float weight_at(const void* w, int wbf, int i) {
  return wbf ? __bfloat162float(static_cast<const bf16*>(w)[i]) : static_cast<const float*>(w)[i];
}

// (n, mean, m2) += (nb, mean_b, m2_b): Chan et al.'s pairwise merge of two
// partial counts, means and sums of squared deviations. An empty left side
// (0, 0, 0) takes the right one's values exactly.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                           float mean_b, float m2_b) {
  if (nb == 0.f) return;
  const float nt = n + nb;
  const float d = mean_b - mean;
  const float f = __fdividef(nb, nt);
  mean += d * f;
  m2 += m2_b + d * d * n * f;
  n = nt;
}

// Chan merges over the 32 lanes of a full warp by a butterfly; lane 0 ends
// with the merge in a fixed order. (A block of C / 8 x k threads may end in
// a partial warp: the merges below run on the full warps only.)
__device__ __forceinline__ void warp_chan_merge(float& n, float& mean, float& m2) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, o);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, o);
    const float qb = __shfl_xor_sync(0xffffffffu, m2, o);
    chan_merge(n, mean, m2, nb, mb, qb);
  }
}

// One Welford step of this thread's E channels by v (x - shift).
template <int E>
__device__ __forceinline__ void welford(float& cnt, float (&mean)[E], float (&m2)[E],
                                        const float (&v)[E], const float (&shift)[E]) {
  cnt += 1.f;
  const float inv = __frcp_rn(cnt);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const float y = v[j] - shift[j];
    const float d = y - mean[j];
    mean[j] += d * inv;
    m2[j] += d * (y - mean[j]);
  }
}

// ---- cluster primitives (raw PTX) -----------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// p's shared-memory address in CTA `rank` of this cluster.
__device__ __forceinline__ uint32_t cluster_map(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float4 cluster_load4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// ---- GroupNorm -------------------------------------------------------------

// Threads of a GN block: C / 8 per row, k = max(1, 256 / (C / 8)) rows per
// step; up to 256 (C <= 2048) the kernels are built for two blocks an SM
// (128 registers a thread), else for one of up to 512.
static inline int gn_threads(int c) {
  const int tpr = c / GN_E;
  return tpr * (tpr >= 256 ? 1 : 256 / tpr);
}

// Dynamic shared memory of gn_cluster_kernel: the `keep` rows of the slab,
// GN_PIECES mbarriers, two (mean, M2) partials per thread, two float4 per
// group.
static inline int gn_cluster_smem(int keep, int c, int isz, int groups) {
  return keep * c * isz + 8 * GN_PIECES + 16 * gn_threads(c) + 32 * groups;
}

// This thread's E channels c0.. merged into (at most) two group partials
// (mean, M2): lo for the channels of group c0 / cg, hi for those of the next
// one (their counts follow from the thread's rows, merge_block_groups).
template <int E>
__device__ __forceinline__ void channels_to_groups(int c0, int cg, float cnt,
                                                   const float (&mean)[E], const float (&m2)[E],
                                                   float2& lo, float2& hi) {
  const int split = (c0 / cg + 1) * cg - c0;   // channels of the first group
  float nl = 0.f, ml = 0.f, ql = 0.f, nh = 0.f, mh = 0.f, qh = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (j < split) chan_merge(nl, ml, ql, cnt, mean[j], m2[j]);
    else chan_merge(nh, mh, qh, cnt, mean[j], m2[j]);
  }
  lo = make_float2(ml, ql);
  hi = make_float2(mh, qh);
}

// The lanes a warp gives one group's merge: the next power of two >= n, at
// most 32.
__device__ __forceinline__ int segment_width(int n) {
  int seg = 1;
  while (seg < n && seg < 32) seg <<= 1;
  return seg;
}

// Group g's partial over the block's threads (tpl / tph: each thread's lo
// and hi partials; thread slot s walked the rows r < nr with r % k == s),
// by the block's full warps, 32 / seg groups a warp at a time: lane li of
// a group's segment merges its contributors li, li + seg, .. in order, then
// a butterfly over the segment; `out` gets (count, mean, M2).
__device__ __forceinline__ void merge_block_groups(const float2* tpl, const float2* tph,
                                                   float4* out, int c, int groups, int tpr,
                                                   int k, int e, int nr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int cg = c / groups;
  const int seg = segment_width(k * ((cg - 1) / e + 2)), li = lane % seg;
  const int per_warp = 32 / seg;
  for (int g0 = warp * per_warp; warp < nw && g0 < groups; g0 += nw * per_warp) {
    const int g = g0 + lane / seg;
    float nn = 0.f, mu = 0.f, q = 0.f;
    if (g < groups) {
      const int cv0 = g * cg / e, ncv = ((g + 1) * cg - 1) / e - cv0 + 1;
      for (int i = li; i < ncv * k; i += seg) {
        const int cv = cv0 + i % ncv, s = i / ncv, t = s * tpr + cv;
        const int split = ((cv * e) / cg + 1) * cg - cv * e;
        const bool lo = cv * e / cg == g;
        const float rows = s < nr ? (float)((nr - s + k - 1) / k) : 0.f;
        const float2 p = lo ? tpl[t] : tph[t];
        chan_merge(nn, mu, q, rows * (lo ? min(e, split) : e - split), p.x, p.y);
      }
    }
    for (int o = seg >> 1; o > 0; o >>= 1) {
      const float nb = __shfl_xor_sync(0xffffffffu, nn, o);
      const float mb = __shfl_xor_sync(0xffffffffu, mu, o);
      const float qb = __shfl_xor_sync(0xffffffffu, q, o);
      chan_merge(nn, mu, q, nb, mb, qb);
    }
    if (li == 0 && g < groups) out[g] = make_float4(nn, mu, q, 0.f);
  }
}

// This thread's Welford walk over rows r0 + slot, r0 + slot + k, .. < r1 of
// `src` (rows of c elements), then its two group partials into tpl / tph.
template <typename T>
struct GnThread {
  static constexpr int E = GN_E;
  int slot, c0, cg;
  float cnt = 0.f, mean[E], m2[E], shift[E];

  __device__ GnThread(const T* sample, int c, int groups, int tpr) {
    slot = threadIdx.x / tpr;
    c0 = (threadIdx.x % tpr) * E;
    cg = c / groups;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      mean[j] = m2[j] = 0.f;
      shift[j] = to_float(sample[(c0 + j) / cg * cg]);
    }
  }

  // Rows r0 <= r < r1 with r % k == slot, U of them loaded before any is used.
  template <int U>
  __device__ __forceinline__ void walk(const T* src, int c, int r0, int r1, int k) {
    int r = r0 + (slot + k - r0 % k) % k;
    for (; r + (U - 1) * k < r1; r += U * k) {
      float a[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u) load8(src + (size_t)(r + u * k) * c + c0, a[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) welford<E>(cnt, mean, m2, a[u], shift);
    }
    for (; r < r1; r += k) {
      float a[E];
      load8(src + (size_t)r * c + c0, a);
      welford<E>(cnt, mean, m2, a, shift);
    }
  }

  // The two group partials (C / G >= E), for merge_block_groups.
  __device__ __forceinline__ void publish(float2* tpl, float2* tph) const {
    float2 lo, hi;
    channels_to_groups<E>(c0, cg, cnt, mean, m2, lo, hi);
    tpl[threadIdx.x] = lo;
    tph[threadIdx.x] = hi;
  }

  // Each channel's partial (any C / G), for merge_block_channels: smean and
  // sm2 (k rows of c), scnt (k).
  __device__ __forceinline__ void publish_channels(float* smean, float* sm2, float* scnt,
                                                   int c) const {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      smean[slot * c + c0 + j] = mean[j];
      sm2[slot * c + c0 + j] = m2[j];
    }
    if (c0 == 0) scnt[slot] = cnt;
  }
};

// As merge_block_groups from per-channel partials: group g's k * (C / G)
// (slot, channel) partials.
__device__ __forceinline__ void merge_block_channels(const float* smean, const float* sm2,
                                                     const float* scnt, float4* out, int c,
                                                     int groups, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int cg = c / groups;
  for (int g = warp; warp < nw && g < groups; g += nw) {
    float nn = 0.f, mu = 0.f, q = 0.f;
    for (int i = lane; i < k * cg; i += 32) {
      const int s = i / cg, ch = g * cg + i % cg;
      chan_merge(nn, mu, q, scnt[s], smean[s * c + ch], sm2[s * c + ch]);
    }
    warp_chan_merge(nn, mu, q);
    if (lane == 0) out[g] = make_float4(nn, mu, q, 0.f);
  }
}

// y = ((x - shift) - mean) * rstd * w + b over this thread's E channels,
// with SiLU after it for kernel 4. w and b are read when it is made (early,
// so their loads overlap the statistics), the group statistics later.
template <typename T, bool SILU>
struct GnApply {
  static constexpr int E = GN_E;
  float sh[E], mu[E], rs[E], ww[E], bb[E];

  __device__ GnApply(const void* w, const void* b, int wbf, int c0) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      ww[j] = weight_at(w, wbf, c0 + j);
      bb[j] = weight_at(b, wbf, c0 + j);
    }
  }

  // gstat: (shift, mean, rstd) per group.
  __device__ __forceinline__ void set_stats(const float4* gstat, int c0, int cg) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float4 s = gstat[(c0 + j) / cg];
      sh[j] = s.x;
      mu[j] = s.y;
      rs[j] = s.z;
    }
  }

  __device__ __forceinline__ void operator()(float (&v)[E]) const {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      v[j] = ((v[j] - sh[j]) - mu[j]) * rs[j] * ww[j] + bb[j];
      if (SILU) v[j] = v[j] / (1.f + expf(-v[j]));
    }
  }
};

// One cluster of gridDim.x CTAs per sample (blockIdx.y); CTA r holds rows
// [r * per, min(rows, (r + 1) * per)) of it. See the note at the top.
template <typename T, bool SILU, int NT>
__global__ void __launch_bounds__(NT, 512 / NT)
    gn_cluster_kernel(const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ w,
                      const void* __restrict__ b, int wbf, int rows, int c, int groups,
                      int per, int keep, float eps) {
  constexpr int E = GN_E;
  extern __shared__ __align__(128) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)keep * c * sizeof(T));
  float4* cpart = reinterpret_cast<float4*>(bars + GN_PIECES);   // read by the cluster
  float4* gstat = cpart + groups;     // (shift, mean, rstd) per group
  float2* tpl = reinterpret_cast<float2*>(gstat + groups);
  float2* tph = tpl + blockDim.x;
  const int cs = gridDim.x, rank = blockIdx.x, tid = threadIdx.x;
  const int r0 = min(rows, rank * per), nr = min(rows, r0 + per) - r0;
  const int nk = min(nr, keep), rpp = (nk + GN_PIECES - 1) / GN_PIECES;   // rows kept
  const T* xs = x + (size_t)blockIdx.y * rows * c;
  const size_t row_bytes = (size_t)c * sizeof(T);
  if (tid == 0) {
    for (int p = 0; p < GN_PIECES; ++p) mbar_init(&bars[p], 1);
    mbar_init_fence();
    for (int p = 0; p < GN_PIECES; ++p) {
      const int lo = p * rpp, hi = min(nk, lo + rpp);
      if (hi <= lo) break;
      const uint32_t bytes = (uint32_t)((hi - lo) * row_bytes);
      mbar_expect_tx(&bars[p], bytes);
      bulk_load(slab + (size_t)lo * c, xs + (size_t)(r0 + lo) * c, bytes, &bars[p]);
    }
  }
  const int tpr = c / E, k = blockDim.x / tpr, cg = c / groups;
  // while the slab arrives: the shifts, w and b, each group's shift
  GnThread<T> st(xs, c, groups, tpr);
  GnApply<T, SILU> apply(w, b, wbf, st.c0);
  for (int g = tid; g < groups; g += blockDim.x) gstat[g].x = to_float(xs[g * cg]);
  __syncthreads();   // the barriers' init is visible
  // the rows past `keep` from device memory while the slab arrives
  st.template walk<4>(xs + (size_t)r0 * c, c, nk, nr, k);
  for (int p = 0; p < GN_PIECES; ++p) {
    const int lo = p * rpp, hi = min(nk, lo + rpp);
    if (hi <= lo) break;
    mbar_wait(&bars[p], 0);
    st.template walk<2>(slab, c, lo, hi, k);
  }
  st.publish(tpl, tph);
  __syncthreads();
  merge_block_groups(tpl, tph, cpart, c, groups, tpr, k, E, nr);
  cluster_arrive();   // cpart written (release) ..
  cluster_wait();     // .. and every CTA's visible (acquire)
  {
    // 32 / seg groups a warp: lane r of a group's segment reads rank r's
    // partial, then the segment merges them in rank order (by shuffles)
    const int warp = tid >> 5, lane = tid & 31, nw = blockDim.x >> 5;
    const int seg = segment_width(cs), li = lane % seg, per_warp = 32 / seg;
    for (int g0 = warp * per_warp; warp < nw && g0 < groups; g0 += nw * per_warp) {
      const int g = g0 + lane / seg;
      float4 pr = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < groups && li < cs) pr = cluster_load4(cluster_map(&cpart[g], li));
      float nn = 0.f, mu = 0.f, q = 0.f;
      for (int rr = 0; rr < cs; ++rr) {
        const int src = lane - li + rr;
        chan_merge(nn, mu, q, __shfl_sync(0xffffffffu, pr.x, src),
                   __shfl_sync(0xffffffffu, pr.y, src), __shfl_sync(0xffffffffu, pr.z, src));
      }
      if (li == 0 && g < groups) {
        gstat[g].y = mu;
        gstat[g].z = rsqrtf(q / nn + eps);
      }
    }
  }
  __syncthreads();
  cluster_arrive();   // this CTA has read the others' partials
  apply.set_stats(gstat, st.c0, cg);
  T* ys = y + ((size_t)blockIdx.y * rows + r0) * c + st.c0;
  // the rows past `keep` again (from L2: read a few microseconds ago), then
  // the slab
  const T* xr = xs + (size_t)r0 * c + st.c0;
  for (int r = nk + (st.slot + k - nk % k) % k; r < nr; r += k) {
    float v[E];
    load8(xr + (size_t)r * c, v);
    apply(v);
    store8(ys + (size_t)r * c, v);
  }
  const T* src = slab + st.c0;
  for (int r = st.slot; r < nk; r += k) {
    float v[E];
    load8(src + (size_t)r * c, v);
    apply(v);
    store8(ys + (size_t)r * c, v);
  }
  cluster_wait();     // keep cpart alive until every CTA has read it
}

// Two-pass statistics: one block per (chunk, sample), chunk rows
// [chunk * per, min(rows, (chunk + 1) * per)) read from device memory; one
// (mean, M2) of x - K per (sample, chunk, group) into part.
template <typename T, int NT>
__global__ void __launch_bounds__(NT, 512 / NT)
    gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int rows, int c,
                    int groups, int per, int chunks) {
  constexpr int E = GN_E;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * per, r1 = min(rows, r0 + per);
  const T* xs = x + (size_t)n * rows * c;
  const int tpr = c / E, k = blockDim.x / tpr;
  float4* gp = reinterpret_cast<float4*>(smem);
  float* smean = reinterpret_cast<float*>(gp + groups);
  float* sm2 = smean + k * c;
  float* scnt = sm2 + k * c;
  GnThread<T> st(xs, c, groups, tpr);
  st.template walk<4>(xs, c, r0, r1, k);
  st.publish_channels(smean, sm2, scnt, c);
  __syncthreads();
  merge_block_channels(smean, sm2, scnt, gp, c, groups, k);
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += blockDim.x)
    part[((size_t)n * chunks + chunk) * groups + g] = make_float2(gp[g].y, gp[g].z);
}

// Two-pass apply: merges the sample's chunk partials per group, then
// normalises rows [chunk * per, ..) (SILU: kernel 4's SiLU after it).
template <typename T, bool SILU, int NT>
__global__ void __launch_bounds__(NT, 512 / NT)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ w,
                    const void* __restrict__ b, int wbf, const float2* __restrict__ part,
                    int rows, int c, int groups, int per, int chunks, float eps) {
  constexpr int E = GN_E;
  extern __shared__ __align__(128) unsigned char smem[];
  float4* gstat = reinterpret_cast<float4*>(smem);
  const int n = blockIdx.y, chunk = blockIdx.x, cg = c / groups;
  const T* xs = x + (size_t)n * rows * c;
  const int tpr = c / E, k = blockDim.x / tpr;
  const int slot = threadIdx.x / tpr, c0 = (threadIdx.x % tpr) * E;
  GnApply<T, SILU> apply(w, b, wbf, c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int g = warp; warp < nw && g < groups; g += nw) {
    const float2* pp = part + (size_t)n * chunks * groups + g;
    float nn = 0.f, mu = 0.f, q = 0.f;
    for (int j = lane; j < chunks; j += 32) {
      const float2 pj = pp[(size_t)j * groups];
      chan_merge(nn, mu, q, (float)min(per, rows - j * per) * cg, pj.x, pj.y);
    }
    warp_chan_merge(nn, mu, q);
    if (lane == 0) gstat[g] = make_float4(to_float(xs[g * cg]), mu, rsqrtf(q / nn + eps), 0.f);
  }
  __syncthreads();
  apply.set_stats(gstat, c0, cg);
  const int r0 = chunk * per, r1 = min(rows, r0 + per);
  const size_t base = (size_t)n * rows * c + c0;
  int r = r0 + slot;
  for (; r + k < r1; r += 2 * k) {
    float u[E], v[E];
    load8(x + base + (size_t)r * c, u);
    load8(x + base + (size_t)(r + k) * c, v);
    apply(u);
    apply(v);
    store8(y + base + (size_t)r * c, u);
    store8(y + base + (size_t)(r + k) * c, v);
  }
  if (r < r1) {
    float v[E];
    load8(x + base + (size_t)r * c, v);
    apply(v);
    store8(y + base + (size_t)r * c, v);
  }
}

// Lets a kernel take all of an SM's shared memory and, where `cluster`,
// clusters of up to 16; once per kernel.
template <typename K>
static cudaError_t prepare_kernel(K kern, bool cluster) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && cluster)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <typename T, bool SILU, int NT>
static cudaError_t gn_cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int n,
                                     int cs, int threads, int smem, cudaStream_t stream) {
  static cudaError_t prepared = prepare_kernel(gn_cluster_kernel<T, SILU, NT>, true);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cs, n, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return prepared;
}

// cluster > 0: one launch of gn_cluster_kernel, clusters of `cluster` CTAs
// of `per` rows, the first `keep` of them held in shared memory (part
// unused); else the two passes over `chunks` chunks of `per` rows with part
// as scratch. NT: the kernels' most threads.
template <typename T, bool SILU, int NT>
cudaError_t launch_gn_nt(const T* x, T* y, const void* w, const void* b, int wbf, float2* part,
                         int n, int rows, int c, int groups, int cluster, int per, int keep,
                         int chunks, float eps, cudaStream_t stream) {
  const int threads = gn_threads(c);
  if (cluster > 0) {
    const int smem = gn_cluster_smem(keep, c, sizeof(T), groups);
    if (cluster > GN_MAX_CLUSTER || smem > SMEM_MAX || c / groups < GN_E || keep < 1 ||
        keep > per || (long long)per * cluster < rows)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = gn_cluster_config<T, SILU, NT>(cfg, attr, n, cluster, threads, smem, stream);
    if (e != cudaSuccess) return e;
    return cudaLaunchKernelEx(&cfg, gn_cluster_kernel<T, SILU, NT>, x, y, w, b, wbf, rows, c,
                              groups, per, keep, eps);
  }
  if ((long long)per * chunks < rows || part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(chunks, n);
  const int k = threads / (c / GN_E);
  gn_stats_kernel<T, NT><<<grid, threads, 16 * groups + (2 * k * c + k) * 4, stream>>>(
      x, part, rows, c, groups, per, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T, SILU, NT><<<grid, threads, 16 * groups, stream>>>(
      x, y, w, b, wbf, part, rows, c, groups, per, chunks, eps);
  return cudaGetLastError();
}

template <typename T, bool SILU = false>
cudaError_t launch_gn(const T* x, T* y, const void* w, const void* b, int wbf, float2* part,
                      int n, int rows, int c, int groups, int cluster, int per, int keep,
                      int chunks, float eps, cudaStream_t stream) {
  if (c % 8 || c > 4096 || c % groups || rows < 1 || n < 1 || per < 1)
    return cudaErrorInvalidValue;
  if (gn_threads(c) <= 256)
    return launch_gn_nt<T, SILU, 256>(x, y, w, b, wbf, part, n, rows, c, groups, cluster, per,
                                      keep, chunks, eps, stream);
  return launch_gn_nt<T, SILU, 512>(x, y, w, b, wbf, part, n, rows, c, groups, cluster, per,
                                    keep, chunks, eps, stream);
}

// ---- LayerNorm -------------------------------------------------------------

// The LayerNorm's launch: the persistent tile kernel (tile = 1: `team` lanes
// a row, `vpt` 16-byte chunks a lane in registers or 0, `threads`, tiles of
// `tile_rows` rows, `smem` bytes) or the row kernel (tile = 0: a warp a row,
// `vpt` 8-element vectors a lane, 256 threads).
struct LnPlan {
  int tile, team, vpt, threads, tile_rows, smem;
};

// The chunk counts a lane of the tile kernel may hold in registers (its
// instantiations), at most LN_MAX_VALUES values a lane; 0: the row is read
// from the tile in shared memory for each of its three passes.
constexpr int LN_VPTS[] = {1, 2, 3, 4, 5, 6, 8, 10};
constexpr int LN_MAX_VALUES = 40;

// The tile kernel's plan: the widest team (a power of two up to 32) that
// divides the row's chunks with at most LN_MAX_VALUES values a lane, else 32
// lanes with the last chunks masked, in registers if they fit, else streamed
// from shared memory (vpt 0); tiles of about LN_TILE_BYTES in whole teams'
// rows; LN_THREADS threads or fewer (one tile's rows), a multiple of 32.
static inline LnPlan ln_tile_plan(int c, int isz) {
  const int e = 16 / isz, nch = c * isz / 16, row_bytes = c * isz;
  int team = 32;
  while (team > 1 && (nch % team || nch / team * e > LN_MAX_VALUES)) team >>= 1;
  if (nch % team || nch / team * e > LN_MAX_VALUES) team = 32;
  const int need = (nch + team - 1) / team;
  int vpt = 0;
  for (int v : LN_VPTS)
    if (v >= need && v * e <= LN_MAX_VALUES) {
      vpt = v;
      break;
    }
  const int by_bytes = LN_TILE_BYTES / row_bytes > 1 ? LN_TILE_BYTES / row_bytes : 1;
  const int teams = LN_THREADS / team < by_bytes ? LN_THREADS / team : by_bytes;
  const int tile_rows = by_bytes / teams * teams;
  const int threads = (teams * team + 31) / 32 * 32;
  // the ring, w and b as fp32, the barriers
  const int smem = LN_STAGES * tile_rows * row_bytes + 8 * c + 8 * LN_STAGES;
  return {1, team, vpt, threads, tile_rows, smem};
}

// The row kernel's plan: 32 lanes a row, the row's C / 8 vectors on them
// rounded up to a power of two a lane (the kernel's instantiations).
static inline LnPlan ln_row_plan(int c) {
  int vpl = 1;
  while (vpl * 32 < c / 8) vpl <<= 1;
  return {0, 32, vpl, 256, 0, 0};
}

// The LayerNorm's launch at (rows, c): the tile kernel in bf16 from C =
// 1280 where x is at least LN_TILE_MIN_BYTES, else the row kernel (see the
// note at the top).
static inline LnPlan ln_plan(int rows, int c, int isz) {
  if (isz == 2 && c >= 1280 && (long long)rows * c * isz >= LN_TILE_MIN_BYTES)
    return ln_tile_plan(c, isz);
  return ln_row_plan(c);
}

// Sum over the `team` lanes of a row (a power of two dividing 32); every lane
// of the warp takes part.
__device__ __forceinline__ float team_sum(float v, int team) {
  for (int o = team >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row, 8 rows a block; lane l holds the 8-element vectors l,
// l + 32, .. of its row (VPL of them) in registers, loaded from device
// memory, and reads w and b (bf16 or fp32, W) as it stores. A row is summed
// in a fixed order (each lane in order, then a butterfly over the warp).
template <typename T, typename W, int VPL>
__global__ void __launch_bounds__(256)
    ln_row_kernel(const T* __restrict__ x, T* __restrict__ y, const W* __restrict__ w,
                  const W* __restrict__ b, int rows, int c, float eps,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nv = c >> 3;
  const T* xr = x + (size_t)row * c;
  float v[VPL][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nv) {
      load8(xr + vi * 8, v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[i][j];
    }
  }
  const float mean = warp_sum(s) / c;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / c + eps);
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  T* yr = y + (size_t)row * c;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nv) {
      float ww[8], bb[8];
      load8(w + vi * 8, ww);
      load8(b + vi * 8, bb);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = (v[i][j] - mean) * rstd * ww[j] + bb[j];
      store8(yr + vi * 8, v[i]);
    }
  }
}

template <typename T, typename W>
static cudaError_t ln_row_launch(const T* x, T* y, const W* w, const W* b, int rows, int c,
                                 float eps, cudaStream_t stream, float* mean, float* rstd,
                                 const LnPlan& p) {
  const dim3 grid((rows + 7) / 8);
#define MUDG_LN_ROW(V)                                                                      \
  case V:                                                                                   \
    ln_row_kernel<T, W, V><<<grid, 256, 0, stream>>>(x, y, w, b, rows, c, eps, mean, rstd); \
    break;
  switch (p.vpt) {
    MUDG_LN_ROW(1)
    MUDG_LN_ROW(2)
    MUDG_LN_ROW(4)
    MUDG_LN_ROW(8)
    MUDG_LN_ROW(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef MUDG_LN_ROW
  return cudaGetLastError();
}

// y = (x - mean) * rstd * w + b over one chunk; wc and bc 16-byte aligned.
template <int E>
__device__ __forceinline__ void ln_affine(float (&v)[E], float mean, float rstd,
                                          const float* wc, const float* bc) {
#pragma unroll
  for (int j = 0; j < E; j += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(wc + j);
    const float4 b4 = *reinterpret_cast<const float4*>(bc + j);
    v[j] = (v[j] - mean) * rstd * w4.x + b4.x;
    v[j + 1] = (v[j + 1] - mean) * rstd * w4.y + b4.y;
    v[j + 2] = (v[j + 2] - mean) * rstd * w4.z + b4.z;
    v[j + 3] = (v[j + 3] - mean) * rstd * w4.w + b4.w;
  }
}

// One row of a tile (row: its first element in shared memory; yr: in
// device memory) by its team: lane lt holds chunks lt, lt + team, .. (VPT
// of them in registers; VPT == 0: read from shared memory in each pass).
// Every lane runs the shuffles; a lane of an invalid row stores nothing.
template <typename T, int VPT>
__device__ __forceinline__ void ln_tile_row(const T* row, T* yr, const float* ws,
                                            const float* bs, int c, int nch, int lt, int team,
                                            bool valid, float eps, float& mean, float& rstd) {
  constexpr int E = Chunk<T>::E;
  if constexpr (VPT > 0) {
    float v[VPT][E];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int ch = lt + i * team;
      if (valid && ch < nch) {
        load_chunk(row + ch * E, v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) v[i][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < E; ++j) sum += v[i][j];
    }
    mean = team_sum(sum, team) / c;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (lt + i * team < nch) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float d = v[i][j] - mean;
          sq += d * d;
        }
      }
    }
    rstd = rsqrtf(team_sum(sq, team) / c + eps);
    if (!valid) return;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int ch = lt + i * team;
      if (ch < nch) {
        ln_affine<E>(v[i], mean, rstd, ws + ch * E, bs + ch * E);
        store_chunk(yr + ch * E, v[i]);
      }
    }
  } else {
    float sum = 0.f, sq = 0.f, v[E];
    for (int ch = lt; valid && ch < nch; ch += team) {
      load_chunk(row + ch * E, v);
#pragma unroll
      for (int j = 0; j < E; ++j) sum += v[j];
    }
    mean = team_sum(sum, team) / c;
    for (int ch = lt; valid && ch < nch; ch += team) {
      load_chunk(row + ch * E, v);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float d = v[j] - mean;
        sq += d * d;
      }
    }
    rstd = rsqrtf(team_sum(sq, team) / c + eps);
    for (int ch = lt; valid && ch < nch; ch += team) {
      load_chunk(row + ch * E, v);
      ln_affine<E>(v, mean, rstd, ws + ch * E, bs + ch * E);
      store_chunk(yr + ch * E, v);
    }
  }
}

// Persistent LayerNorm over tiles of `tile_rows` rows in a ring of
// LN_STAGES (see the note at the top); `team` lanes per row, ln_row's VPT.
// mean_out and rstd_out, where not null, get each row's statistics (kernel
// 9's LN backward reads them).
template <typename T, int VPT>
__global__ void __launch_bounds__(LN_THREADS, 3)
    ln_tile_kernel(const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ w,
                   const void* __restrict__ b, int wbf, int rows, int c, int team,
                   int tile_rows, float eps, float* __restrict__ mean_out,
                   float* __restrict__ rstd_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row_bytes = c * sizeof(T), tile_bytes = tile_rows * row_bytes;
  float* ws = reinterpret_cast<float*>(smem + LN_STAGES * tile_bytes);
  float* bs = ws + c;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + c);
  const int tid = threadIdx.x, lt = tid % team, tm = tid / team, nteams = blockDim.x / team;
  const int nch = row_bytes / 16, tiles = (rows + tile_rows - 1) / tile_rows;
  auto issue = [&](int t, int s) {
    const int r0 = t * tile_rows, nr = min(tile_rows, rows - r0);
    const uint32_t bytes = (uint32_t)nr * row_bytes;
    mbar_expect_tx(&full[s], bytes);
    bulk_load(smem + s * tile_bytes, x + (size_t)r0 * c, bytes, &full[s]);
  };
  if (tid == 0) {   // the first tiles' copies go out before anything else
    for (int s = 0; s < LN_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int s = 0; s < LN_STAGES; ++s)
      if (blockIdx.x + s * gridDim.x < tiles) issue(blockIdx.x + s * gridDim.x, s);
  }
#pragma unroll 4
  for (int i = tid; i < c; i += blockDim.x) {
    ws[i] = weight_at(w, wbf, i);
    bs[i] = weight_at(b, wbf, i);
  }
  __syncthreads();
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int s = it % LN_STAGES;
    mbar_wait(&full[s], (it / LN_STAGES) & 1);
    const int r0 = t * tile_rows, nr = min(tile_rows, rows - r0);
    const T* tile = reinterpret_cast<const T*>(smem + s * tile_bytes);
    const int steps = (nr + nteams - 1) / nteams;
    for (int k = 0; k < steps; ++k) {
      const int q = tm + k * nteams;
      const bool valid = q < nr;
      const size_t row = (size_t)r0 + (valid ? q : 0);
      float mean, rstd;
      ln_tile_row<T, VPT>(tile + (size_t)(valid ? q : 0) * c, y + row * c, ws, bs, c, nch, lt,
                          team, valid, eps, mean, rstd);
      if (valid && mean_out != nullptr && lt == 0) {
        mean_out[row] = mean;
        rstd_out[row] = rstd;
      }
    }
    __syncthreads();   // every thread is done with stage s
    if (tid == 0 && t + LN_STAGES * gridDim.x < tiles) {
      fence_proxy_async();
      issue(t + LN_STAGES * gridDim.x, s);
    }
  }
}

// The grid of ln_tile_kernel<T, VPT>: the SM count times the blocks of
// `threads` with `smem` bytes that fit one SM (cached per kernel for the last
// (threads, smem) asked), or the tiles if fewer.
template <typename T, int VPT>
static cudaError_t ln_grid(int threads, int smem, int tiles, int& grid) {
  static cudaError_t prepared = prepare_kernel(ln_tile_kernel<T, VPT>, false);
  static int last_threads = 0, last_smem = 0, per_sm = 0;
  static const int sms = mudg_host::sm_count();
  if (prepared != cudaSuccess) return prepared;
  if (threads != last_threads || smem != last_smem) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_tile_kernel<T, VPT>, threads, smem);
    if (e != cudaSuccess) return e;
    last_threads = threads;
    last_smem = smem;
  }
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  return cudaSuccess;
}

// The plan's kernel: launches it (x != nullptr) or only sizes its grid.
template <typename T, int VPT>
static cudaError_t ln_run(const T* x, T* y, const void* w, const void* b, int wbf, int rows,
                          int c, float eps, cudaStream_t stream, float* mean, float* rstd,
                          const LnPlan& p, int& grid) {
  if constexpr (VPT * Chunk<T>::E > LN_MAX_VALUES) {
    return cudaErrorInvalidValue;   // never planned
  } else {
    const int tiles = (rows + p.tile_rows - 1) / p.tile_rows;
    cudaError_t e = ln_grid<T, VPT>(p.threads, p.smem, tiles, grid);
    if (e != cudaSuccess || x == nullptr) return e;
    ln_tile_kernel<T, VPT><<<grid, p.threads, p.smem, stream>>>(
        x, y, w, b, wbf, rows, c, p.team, p.tile_rows, eps, mean, rstd);
    return cudaGetLastError();
  }
}

// ln_run at the plan's VPT.
template <typename T>
static cudaError_t ln_dispatch(const T* x, T* y, const void* w, const void* b, int wbf,
                               int rows, int c, float eps, cudaStream_t stream, float* mean,
                               float* rstd, const LnPlan& p, int& grid) {
#define MUDG_LN_CASE(V) \
  case V:               \
    return ln_run<T, V>(x, y, w, b, wbf, rows, c, eps, stream, mean, rstd, p, grid);
  switch (p.vpt) {
    MUDG_LN_CASE(0)
    MUDG_LN_CASE(1)
    MUDG_LN_CASE(2)
    MUDG_LN_CASE(3)
    MUDG_LN_CASE(4)
    MUDG_LN_CASE(5)
    MUDG_LN_CASE(6)
    MUDG_LN_CASE(8)
    MUDG_LN_CASE(10)
  }
#undef MUDG_LN_CASE
  return cudaErrorInvalidValue;
}

// The LayerNorm by `p`'s kernel.
template <typename T>
cudaError_t launch_ln_plan(const T* x, T* y, const void* w, const void* b, int wbf, int rows,
                           int c, float eps, cudaStream_t stream, float* mean, float* rstd,
                           const LnPlan& p) {
  if (c % 8 || c > 4096 || c < 8) return cudaErrorInvalidValue;
  if (rows < 1) return cudaSuccess;
  if (p.tile) {
    int grid = 0;
    return ln_dispatch(x, y, w, b, wbf, rows, c, eps, stream, mean, rstd, p, grid);
  }
  if (wbf)
    return ln_row_launch(x, y, static_cast<const bf16*>(w), static_cast<const bf16*>(b), rows, c,
                         eps, stream, mean, rstd, p);
  return ln_row_launch(x, y, static_cast<const float*>(w), static_cast<const float*>(b), rows,
                       c, eps, stream, mean, rstd, p);
}

template <typename T>
cudaError_t launch_ln(const T* x, T* y, const void* w, const void* b, int wbf, int rows, int c,
                      float eps, cudaStream_t stream, float* mean = nullptr,
                      float* rstd = nullptr) {
  return launch_ln_plan(x, y, w, b, wbf, rows, c, eps, stream, mean, rstd,
                        ln_plan(rows, c, sizeof(T)));
}

}  // namespace mudg

using namespace mudg;

// x, y: (n, rows, c) contiguous, bf16 (fp32 = 0) or fp32 (fp32 = 1); w, b:
// (c) bf16 (wbf = 1) or fp32. c % 8 == 0, c <= 4096, groups | c. cluster >
// 0: one launch, clusters of `cluster` CTAs of `per` rows (cluster * per
// >= rows), the first `keep` rows of each held in shared memory and the
// rest read twice (part may be null); cluster == 0: two passes over
// `chunks` chunks of `per` rows, part holding n * chunks * groups (mean,
// M2) fp32 pairs of scratch. kernels/norms.py:gn_plan chooses.
extern "C" int mudg_group_norm(const void* x, void* y, const void* w, const void* b, void* part,
                               int wbf, int n, int rows, int c, int groups, int cluster,
                               int per, int keep, int chunks, int fp32, float eps, void* stream) {
  float2* pp = static_cast<float2*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return launch_gn(static_cast<const float*>(x), static_cast<float*>(y), w, b, wbf, pp, n,
                     rows, c, groups, cluster, per, keep, chunks, eps, s);
  return launch_gn(static_cast<const bf16*>(x), static_cast<bf16*>(y), w, b, wbf, pp, n, rows,
                   c, groups, cluster, per, keep, chunks, eps, s);
}

// y = silu(GroupNorm(x)) in fp32, rounded to bf16 once; x, y: (n, rows, c)
// bf16, w, b fp32, the plan as mudg_group_norm (kernel 4's statistics and h).
extern "C" int mudg_group_norm_silu(const void* x, void* y, const void* w, const void* b,
                                    void* part, int n, int rows, int c, int groups, int cluster,
                                    int per, int keep, int chunks, float eps, void* stream) {
  return launch_gn<bf16, true>(static_cast<const bf16*>(x), static_cast<bf16*>(y), w, b, 0,
                               static_cast<float2*>(part), n, rows, c, groups, cluster, per,
                               keep, chunks, eps, static_cast<cudaStream_t>(stream));
}

template <typename T, bool SILU, int NT>
static cudaError_t gn_max_clusters_nt(int cluster, int c, int smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      gn_cluster_config<T, SILU, NT>(cfg, attr, 1, cluster, gn_threads(c), smem, nullptr);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(out, gn_cluster_kernel<T, SILU, NT>, &cfg);
  return e;
}

template <typename T, bool SILU>
static cudaError_t gn_max_clusters(int cluster, int c, int smem, int* out) {
  return gn_threads(c) <= 256 ? gn_max_clusters_nt<T, SILU, 256>(cluster, c, smem, out)
                              : gn_max_clusters_nt<T, SILU, 512>(cluster, c, smem, out);
}

// Clusters of `cluster` CTAs of gn_cluster_kernel (bf16 or fp32, with or
// without SiLU) with `smem` bytes each that the card holds at once, into
// *out (0: none fits); the planner's check.
extern "C" int mudg_gn_max_clusters(int cluster, int c, int smem, int fp32, int silu, int* out) {
  *out = 0;
  return fp32   ? gn_max_clusters<float, false>(cluster, c, smem, out)
         : silu ? gn_max_clusters<bf16, true>(cluster, c, smem, out)
                : gn_max_clusters<bf16, false>(cluster, c, smem, out);
}

// x, y: (rows, c) contiguous, bf16 or fp32 as above; w, b: (c) fp32.
// c % 8 == 0, c <= 4096.
extern "C" int mudg_layer_norm(const void* x, void* y, const void* w, const void* b,
                               int rows, int c, int fp32, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return launch_ln(static_cast<const float*>(x), static_cast<float*>(y), w, b, 0, rows, c,
                     eps, s);
  return launch_ln(static_cast<const bf16*>(x), static_cast<bf16*>(y), w, b, 0, rows, c, eps,
                   s);
}

// mudg_layer_norm with w and b in bf16 (wbf = 1) or fp32, as the module
// stores them (the Python wrapper's entry); kernel -1: the plan's kernel,
// 0: the row kernel, 1: the tile kernel (to time the two side by side).
extern "C" int mudg_layer_norm_w(const void* x, void* y, const void* w, const void* b, int wbf,
                                 int rows, int c, int fp32, int kernel, float eps,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int isz = fp32 ? 4 : 2;
  const LnPlan p = kernel < 0 ? ln_plan(rows, c, isz) : kernel ? ln_tile_plan(c, isz)
                                                                 : ln_row_plan(c);
  if (fp32)
    return launch_ln_plan(static_cast<const float*>(x), static_cast<float*>(y), w, b, wbf, rows,
                          c, eps, s, nullptr, nullptr, p);
  return launch_ln_plan(static_cast<const bf16*>(x), static_cast<bf16*>(y), w, b, wbf, rows, c,
                        eps, s, nullptr, nullptr, p);
}

// mudg_layer_norm in bf16 that also writes each row's fp32 mean and rstd
// (rows) (kernel 9: xn and the statistics of its LN backward).
extern "C" int mudg_layer_norm_stats(const void* x, void* y, const void* w, const void* b,
                                     void* mean, void* rstd, int rows, int c, float eps,
                                     void* stream) {
  return launch_ln(static_cast<const bf16*>(x), static_cast<bf16*>(y), w, b, 0, rows, c, eps,
                   static_cast<cudaStream_t>(stream), static_cast<float*>(mean),
                   static_cast<float*>(rstd));
}

// The LayerNorm plan at (rows, c) in bf16 or fp32, as launch_ln takes it:
// out = {tile, team, vpt, threads, tile_rows, smem, grid} (LnPlan and the
// grid it launches).
extern "C" int mudg_ln_plan(int rows, int c, int fp32, int* out) {
  const LnPlan p = ln_plan(rows, c, fp32 ? 4 : 2);
  int grid = (rows + 7) / 8;
  cudaError_t e = cudaSuccess;
  if (p.tile)
    e = fp32 ? ln_dispatch<float>(nullptr, nullptr, nullptr, nullptr, 0, rows, c, 0.f, nullptr,
                                  nullptr, nullptr, p, grid)
             : ln_dispatch<bf16>(nullptr, nullptr, nullptr, nullptr, 0, rows, c, 0.f, nullptr,
                                 nullptr, nullptr, p, grid);
  const int vals[7] = {p.tile, p.team, p.vpt, p.threads, p.tile_rows, p.smem, grid};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return e;
}
