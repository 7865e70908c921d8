// Kernel 13: front-to-back alpha compositing of (tile, depth)-sorted
// gaussian/tile pairs per 16x16 tile, and its backward.
//
// Replaces: mudg_tpu/gs/tile_raster.py:_fwd_kernel (pallas_call at :535) and
// _bwd_kernel (pallas_call at :709), the custom-vjp op composite_tiles :722.
//
// Input: a row-major pair table feats (P, nfeat) f32, nfeat = 6 + npay, row
// [mux, muy, conic a, b, c, opacity, payload...] with payload = [r, g, b,
// depth, extras...], sorted by (tile, depth); bounds (n_tiles + 1) i32, tile
// t's pairs are rows bounds[t] .. bounds[t+1]. Output out (n_tiles, npay + 1,
// 256) f32: the payload sums and the final transmittance T per pixel, and
// last (n_tiles, 256) i32: per pixel, 1 + the index within its tile of the
// last pair that contributed (0 if none), which the backward starts from.
//
// Semantics (mudg_tpu/gs/rasterize.py:165-184): pixel centres at +0.5,
// alpha = min(op * exp(power), 0.999), zero below 1/255, a pair contributes
// only where the transmittance before it is above 1e-4, the payload is
// accumulated with weight alpha * T.
//
// Bound on this card: FP32 instruction issue. Per (pair, pixel) evaluation
// the forward does ~12 operations and an exp (about 25 instructions with
// the accurate expf), plus 2 * npay for a contributing pair, over only
// 4 * nfeat bytes per pair and 4 * (npay + 1) per pixel; the backward ~3x
// that, plus a sum over the tile's 256 pixels of each of a pair's 6 + npay
// gradient terms. Pair counts differ between tiles by orders of magnitude,
// so the schedule decides how much of the card the heaviest tiles leave
// idle, and where an image has few tiles one heavy tile's walk sets the
// time.
//
// Design (both directions):
// - Two pixels per thread, (x, y) and (x, y + 4), 128 threads a tile, each
//   warp on an 8 x 8 quadrant: the pair's loads, its index arithmetic and
//   the terms of its power that depend on dx alone are shared by the two
//   pixels, and the backward's sum over the tile's pixels adds two pixels
//   in registers before any shuffle. Where the image has so few tiles that
//   both halves of every tile fit on the card at once (the 256 x 160
//   refine-gs default: 160 tiles), the forward takes each half of a tile
//   in a block of its own, one pixel a thread (a warp on 8 x 4 pixels):
//   there the heaviest tile's walk sets the time, and one pixel a thread
//   halves it.
// - Each pair carries a box of the pixel centres where its alpha can reach
//   1/255 (below); a warp whose pixels the box misses skips the pair after
//   one LDS.128 and four compares. Every other evaluation forms alpha op
//   by op as the plain version does (pair_powers: __fmul_rn / __fadd_rn,
//   the accurate expf, no FMA contraction up to alpha), so every
//   alpha >= 1/255 decision and every T > 1e-4 gate is the plain
//   version's. (A per-warp vote to skip the exp, and a per-lane bound test,
//   cost more in branches than they saved on the card.)
// - A persistent grid, as many blocks as fit on the SMs. `tile_order_kernel`
//   (launched first, in the same call: each tile's rank among all keys,
//   counted by 8 threads, no atomics) sorts the tiles heaviest first: the
//   forward by pair count, the backward by the largest `last` of the tile.
//   Block b takes entries b, 2G - 1 - b, 2G + b, ... of that order (G
//   blocks, a snake over rounds), so the heavy tiles start first and every
//   block gets a mix of heavy and light ones.
// - Each block streams its tiles' pair rows as one sequence of stages
//   through a shared-memory slot filled by cp.async.bulk (a 1-D bulk copy
//   completed on an mbarrier) and re-laid, stage by stage, into a second
//   buffer: thread 0 issues the next stage into the slot as soon as it is
//   re-laid, across tile boundaries, so a copy is in flight while the
//   block composites. Rows are 4 * nfeat bytes and start anywhere; a copy
//   takes the 16-byte-aligned span around its rows (the last bytes of the
//   table past a 16-byte boundary by plain loads), and the consumer starts
//   at the offset within it.
// - The re-laid rows have 16-byte fields: [mux, muy, a, b], [c, op, 0, 0],
//   [box], [payload] padded to a multiple of four, so that an evaluation
//   loads three float4 (LDS.128, one address for the warp) and a
//   contributing pair its payload float4s.
// - The box: with thr = min(log(1/255 / op) - 1e-3, 0) (0 for op <= 0),
//   power < thr gives exp(power) < (1/255 / op) * exp(-1e-3 + the logf and
//   subtraction rounding, < 1e-4), and expf's and the product's rounding
//   (< 3e-7 relative) keep op * expf(power) below 1/255. relay_row bounds
//   the ellipse power >= thr, widened to cover the float power's rounding.
//
// Forward: UNROLL pairs at a time, their alphas first (independent of T, so
// their arithmetic overlaps), then the running product T *= (1 - alpha) in
// order (the TPU's log-space triangular matmul fed the MXU and has no
// purpose here). A warp leaves the stage once none of its pixels has
// T > 1e-4, and the block leaves the tile at the end of a stage where no
// pixel has (__syncthreads_count); the tile's stage already in flight is
// drained and no more are issued.
//
// Backward: a back-to-front walk from the forward's final T, as the public
// CUDA 3DGS rasterizer does. With S the sum over the later pairs of w * G
// (G = payload . dL/dpayload) plus the tail T_final * dL/dT_final,
//   T_before = T_after / (1 - alpha),
//   dL/dalpha = T_before * G - S / (1 - alpha),   S += alpha * T_before * G
// (1 / (1 - alpha) by the SFU's reciprocal, within 2 ulp). The walk starts
// at the pixel's last contributing pair (from `last`), so the T > 1e-4 gate
// is never re-decided from a reconstructed T, and keeps no total - prefix
// difference: the TPU's two forward sweeps (totals, then prefix with suffix
// = total - prefix) cancel where tiles saturate, while here S is summed
// from the small end. Stages walk down from the tile's largest `last`. Each
// pair's gradient row is a sum over the 256 pixels: a thread adds its two
// pixels' terms for a group of GP pairs (GP * (6 + MAXP) <= 32 values:
// dpow dx, dpow dy, dpow dx^2, dpow dx dy, dpow dy^2, dalpha g2d and
// w dL/dpayload, dpow = dalpha * alpha) into 32 registers, the warp
// reduce-scatters them (31 shuffles leave lane L with the warp's sum of
// value L; a per-pair butterfly takes 5 shuffles per value), lane L forms
// its gradient term from that sum (the mean's and the conic's from the
// sums of the first five and the pair's conic) and stores it to the warp's
// partials, and at the end of the stage the 4 warps' partials are summed in
// a fixed order and written once per pair row. No atomics: two runs agree
// bit for bit. Rows past the tile's largest `last` get zeros.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace mudg {
namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int NT = NPIX / 2;           // threads a tile: two pixels each
constexpr int NWARP = NT / 32;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.999f;
constexpr float T_MIN = 1e-4f;
constexpr float SKIP_MARGIN = 1e-3f;   // of thr below log(1/255 / op)
constexpr int MAX_PAY = 26;
constexpr int UNROLL = 4;              // forward pairs whose alphas are formed together
constexpr float BOX_SCALE = 1.01f;     // a pair's box: its thr ellipse's extent x 1.01
constexpr float BOX_PAD = 0.01f;       //   + 0.01 px
constexpr float RHO2_MAX = 0.999f;     // no box for a conic with b^2 >= RHO2_MAX a c
constexpr int ORDER_TILES = 32;        // tiles a block of tile_order_kernel ranks
constexpr int ORDER_SPLIT = 8;         // threads a tile (each compares 1/8 of the keys)
constexpr int ORDER_CHUNK = 2048;      // keys a block holds at once
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

template <int MAXP>
struct Cfg {
  static constexpr int NF = 6 + MAXP;                   // gradient terms per pair
  static constexpr int PAY4 = round4(MAXP) / 4;         // payload float4s
  static constexpr int R4 = 3 + PAY4;                   // float4s per re-laid row
  static constexpr int FWD_ROWS = MAXP <= 8 ? 256 : 128;   // rows per forward stage
  static constexpr int BWD_ROWS = MAXP <= 8 ? 128 : 64;    // rows per backward stage
  static constexpr int GP = NF <= 16 ? 32 / NF : 1;     // pairs per reduce-scatter
};

// floats of the raw slot: B rows and the up to 3 floats before the first
// and after the last that the 16-byte-aligned span adds, rounded to 128
// bytes
__host__ __device__ inline int slot_floats(int rows, int nfeat) {
  return (rows * nfeat + 6 + 31) & ~31;
}

template <int MAXP>
__host__ __device__ inline size_t fwd_smem(int nfeat) {
  using C = Cfg<MAXP>;
  return sizeof(float) * (slot_floats(C::FWD_ROWS, nfeat) + C::FWD_ROWS * C::R4 * 4);
}

template <int MAXP>
__host__ __device__ inline size_t bwd_smem(int nfeat) {
  using C = Cfg<MAXP>;
  return sizeof(float) * (slot_floats(C::BWD_ROWS, nfeat) + C::BWD_ROWS * C::R4 * 4 +
                          NWARP * C::BWD_ROWS * C::NF);
}

// A tile's sort key: its work above its complemented index, so that keys
// are unique and a larger key comes first (heavier, then lower index).
__device__ __forceinline__ unsigned long long order_key(const int* bounds, const int* work,
                                                        int t) {
  const int w = work ? work[t] : bounds[t + 1] - bounds[t];
  return ((unsigned long long)(unsigned)max(w, 0) << 32) | (unsigned)~(unsigned)t;
}

// The tiles heaviest first, ties by index: order[rank(t)] = t, where rank(t)
// is the number of tiles with a larger key. The work of tile t is work[t],
// or bounds[t + 1] - bounds[t] without work. A block ranks ORDER_TILES
// tiles, ORDER_SPLIT threads each comparing a share of all n keys (held in
// shared memory ORDER_CHUNK at a time); no atomics.
__global__ void __launch_bounds__(ORDER_TILES * ORDER_SPLIT)
tile_order_kernel(const int* __restrict__ bounds, const int* __restrict__ work, int n,
                  int* __restrict__ order) {
  __shared__ unsigned long long keys[ORDER_CHUNK];
  const int t = blockIdx.x * ORDER_TILES + threadIdx.x / ORDER_SPLIT;
  const int sub = threadIdx.x % ORDER_SPLIT;
  const unsigned long long mine = t < n ? order_key(bounds, work, t) : ~0ull;
  int rank = 0;
  for (int c0 = 0; c0 < n; c0 += ORDER_CHUNK) {
    const int m = min(ORDER_CHUNK, n - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) keys[i] = order_key(bounds, work, c0 + i);
    __syncthreads();
#pragma unroll 4
    for (int i = sub; i < m; i += ORDER_SPLIT) rank += keys[i] > mine;
  }
#pragma unroll
  for (int o = ORDER_SPLIT / 2; o > 0; o >>= 1) rank += __shfl_xor_sync(FULL, rank, o);
  if (t < n && sub == 0) order[rank] = t;
}

// The k-th unit of this block (-1 past the end): entry k * G + b of the
// units in even rounds, k * G + G - 1 - b in odd ones.
__device__ __forceinline__ int block_unit(int k, int n_units) {
  const int g = gridDim.x, b = blockIdx.x;
  const long long i = (long long)k * g + ((k & 1) ? g - 1 - b : b);
  return i < n_units ? (int)i : -1;
}

// The k-th tile of this block, one unit a tile (-1 past the end).
__device__ __forceinline__ int block_tile(const int* order, int k, int n_tiles) {
  const int i = block_unit(k, n_tiles);
  return i < 0 ? -1 : order[i];
}

// Rows row0 .. row0 + n of the table into slot, completion on bar (one
// arrival). The bulk copy takes the 16-byte-aligned span from the rows'
// aligned start up to total16, the table's bytes rounded down to 16; the
// bytes past total16 come by plain loads before the arrival. The rows start
// ((row0 * nfeat) & 3) floats into the slot.
__device__ __forceinline__ void issue_rows(float* slot, const float* feats, int row0, int n,
                                           int nfeat, long long total16, uint64_t* bar) {
  const long long b0 = (long long)row0 * nfeat * 4, b1 = (long long)(row0 + n) * nfeat * 4;
  const long long a0 = b0 & ~15ll;
  const long long a1 = min((b1 + 15) & ~15ll, total16);
  const char* base = reinterpret_cast<const char*>(feats);
  for (long long o = max(a0, a1); o < b1; o += 4)
    slot[(o - a0) >> 2] = *reinterpret_cast<const float*>(base + o);
  if (a1 > a0) {
    mbar_expect_tx(bar, (uint32_t)(a1 - a0));
    bulk_load(slot, base + a0, (uint32_t)(a1 - a0), bar);
  } else {
    mbar_arrive(bar);
  }
}

// One raw row re-laid as [mux, muy, a, b], [c, op, 0, 0], [xlo, xhi, ylo,
// yhi], payload (zeros past npay). The box holds every pixel centre where
// power >= thr can hold (the note at the top): the ellipse a dx^2 + 2 b dx
// dy + c dy^2 <= K = -2 thr spans |dx| <= sqrt(K c / det), |dy| <=
// sqrt(K a / det), det = a c - b^2. Outside it scaled by BOX_SCALE, Q =
// a dx^2 + 2 b dx dy + c dy^2 >= 1.0201 K, while the float power's rounding
// is below 5e-7 of (a dx^2 + c dy^2) / 2 + |b dx dy| <= Q / (1 - |rho|),
// |rho| < 0.9995 (RHO2_MAX), i.e. below Q / 1000: the float power is at most
// -0.499 Q <= -0.509 K < thr. (The box's own rounding, below 2e-4 of its
// extent and an ulp of mu, is inside BOX_SCALE and BOX_PAD.) A conic that
// is not positive definite enough, a NaN opacity or another non-finite
// value gets no box (NaN compares false: nothing is culled).
template <int MAXP>
__device__ __forceinline__ void relay_row(const float* src, int npay, float4* dst) {
  const float mux = src[0], muy = src[1], a = src[2], b = src[3], c = src[4], op = src[5];
  float thr = -INFINITY;   // a NaN opacity: never skip
  if (op > 0.f) thr = fminf(logf(ALPHA_MIN / op) - SKIP_MARGIN, 0.f);
  else if (op <= 0.f) thr = 0.f;
  float4 box = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  if (a > 0.f && c > 0.f && b * b < RHO2_MAX * (a * c) && thr > -INFINITY) {
    const float k = -2.f * thr, det = a * c - b * b;
    const float rx = sqrtf(k * c / det) * BOX_SCALE + BOX_PAD;
    const float ry = sqrtf(k * a / det) * BOX_SCALE + BOX_PAD;
    box = make_float4(mux - rx, mux + rx, muy - ry, muy + ry);
  }
  dst[0] = make_float4(mux, muy, a, b);
  dst[1] = make_float4(c, op, 0.f, 0.f);
  dst[2] = box;
#pragma unroll
  for (int q = 0; q < Cfg<MAXP>::PAY4; ++q) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = 4 * q + e < npay ? src[6 + 4 * q + e] : 0.f;
    dst[3 + q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Rows [0, n) of a stage from the raw slot into the re-laid buffer, and
// rows [n, pad) as rows that every warp culls (an empty box).
template <int MAXP>
__device__ __forceinline__ void relay_stage(const float* raw, int n, int pad, int nfeat,
                                            int npay, float4* rel) {
  constexpr int R4 = Cfg<MAXP>::R4;
  for (int i = threadIdx.x; i < pad; i += NT) {
    if (i < n) {
      relay_row<MAXP>(raw + i * nfeat, npay, rel + i * R4);
    } else {
      rel[i * R4 + 2] = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
    }
  }
}

// The thread's warp's pixel centres lie in box q (its 8 x 8 quadrant of the
// tile); a pair whose box misses it is culled by the whole warp.
__device__ __forceinline__ bool culled(float4 box, float4 q) {
  return box.y < q.x || box.x > q.y || box.w < q.z || box.z > q.w;
}

// The powers of one pair at a thread's PPT pixels (one column), rounded op
// by op as -0.5 * (a dx^2 + c dy^2) - b dx dy in the order PyTorch's
// elementwise ops take (no FMA contraction), so that the plain version's
// float32 alpha, and with it every alpha >= 1/255 decision, is the
// kernel's bit for bit; the pixels share dx, a dx^2 and b dx.
template <int PPT>
struct Powers {
  float dx, dy[PPT], p[PPT];
};

template <int PPT>
__device__ __forceinline__ Powers<PPT> pair_powers(float4 g0, float4 g1, float px,
                                                   const float (&py)[PPT]) {
  Powers<PPT> r;
  r.dx = __fsub_rn(px, g0.x);
  const float adx2 = __fmul_rn(__fmul_rn(g0.z, r.dx), r.dx), bdx = __fmul_rn(g0.w, r.dx);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    r.dy[i] = __fsub_rn(py[i], g0.y);
    r.p[i] = __fsub_rn(
        __fmul_rn(-0.5f, __fadd_rn(adx2, __fmul_rn(__fmul_rn(g1.x, r.dy[i]), r.dy[i]))),
        __fmul_rn(bdx, r.dy[i]));
  }
  return r;
}

// One step of reduce_scatter32: a lane keeps the half of v[0 .. 2H) that
// its partner (lane ^ H) does not and adds the partner's copy of it.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

// v[L] summed over the warp lands in lane L (31 shuffles, a fixed order).
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

// A thread's PPT pixels in part `part` of tile t (PPT = 2: the whole tile,
// warp w on the 8 x 8 quadrant (w % 2, w / 2), lane l on column l % 8,
// rows l / 8 and 4 below it; PPT = 1: half `part` of the tile's rows, warp
// w on the 8 x 4 block (w % 2, w / 2) of it, lane l on column l % 8, row
// l / 8). pix0 is the first pixel's index in the tile, pixel i lies 4 i
// rows below it; q gets the warp's box of pixel centres.
template <int PPT>
__device__ __forceinline__ void unit_pixels(int t, int part, int tw, int* pix0, float* px,
                                            float (&py)[PPT], float4* q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = (warp & 1) * 8 + (lane & 7);
  const int y0 = PPT == 2 ? (warp >> 1) * 8 : part * 8 + (warp >> 1) * 4;
  const float tx = (float)((t % tw) * TILE) + 0.5f, ty = (float)((t / tw) * TILE) + 0.5f;
  *pix0 = (y0 + (lane >> 3)) * TILE + x;
  *px = tx + (float)x;
#pragma unroll
  for (int i = 0; i < PPT; ++i) py[i] = ty + (float)(y0 + (lane >> 3) + 4 * i);
  *q = make_float4(tx + (float)((warp & 1) * 8), tx + (float)((warp & 1) * 8 + 7),
                   ty + (float)y0, ty + (float)(y0 + 4 * PPT - 1));
}

// PPT pixels a thread: with PPT = 2 a block composites whole tiles, with
// PPT = 1 halves of tiles (two units a tile, for images with too few tiles
// to fill the card, where a heavy tile's walk sets the time).
template <int MAXP, int PPT>
__global__ void __launch_bounds__(NT, PPT == 2 && MAXP <= 16 ? 6 : 4)
composite_fwd(const float* __restrict__ feats, const int* __restrict__ bounds,
              const int* __restrict__ order, int n_tiles, int tw, int npay, long long total16,
              float* __restrict__ out, int* __restrict__ last) {
  using C = Cfg<MAXP>;
  constexpr int B = C::FWD_ROWS, R4 = C::R4, UPT = 3 - PPT;   // units a tile
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  __shared__ int pstate[2];   // the producer's unit (local index) and next row
  const int nfeat = 6 + npay, n_units = n_tiles * UPT;
  float* raw = reinterpret_cast<float*>(smem);
  float4* rel = reinterpret_cast<float4*>(raw + slot_floats(B, nfeat));
  const int tid = threadIdx.x;

  // producer (thread 0): local unit pk (of tile ptile), rows prow .. pend
  // still to issue
  int pk = 0, ptile = -1, prow = 0, pend = 0;
  auto start_unit = [&]() {
    const int i = block_unit(pk, n_units);
    ptile = i < 0 ? -1 : order[i / UPT];
    if (ptile >= 0) prow = bounds[ptile], pend = bounds[ptile + 1];
  };
  auto issue = [&]() {
    while (ptile >= 0 && prow >= pend) {
      ++pk;
      start_unit();
    }
    if (ptile < 0) return;
    const int n = min(B, pend - prow);
    issue_rows(raw, feats, prow, n, nfeat, total16, &bar);
    prow += n;
  };
  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
    start_unit();
    issue();
  }
  __syncthreads();

  uint32_t phase = 0;   // of the slot's barrier
  for (int k = 0;; ++k) {
    const int i = block_unit(k, n_units);
    if (i < 0) break;
    const int t = order[i / UPT];
    const int start = bounds[t], end = bounds[t + 1];
    int pix0;
    float px, py[PPT];
    float4 quad;
    unit_pixels<PPT>(t, i % UPT, tw, &pix0, &px, py, &quad);
    float T[PPT], acc[PPT][MAXP];
    int lst[PPT];
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      T[p] = 1.f;
      lst[p] = 0;
#pragma unroll
      for (int c = 0; c < MAXP; ++c) acc[p][c] = 0.f;
    }
    auto live = [&]() {
      bool l = false;
#pragma unroll
      for (int p = 0; p < PPT; ++p) l |= T[p] > T_MIN;
      return l;
    };

    for (int r0 = start; r0 < end; r0 += B) {
      const int n = min(B, end - r0);
      mbar_wait(&bar, phase);
      phase ^= 1;
      relay_stage<MAXP>(raw + (((unsigned)r0 * nfeat) & 3), n, (n + UNROLL - 1) / UNROLL * UNROLL,
                        nfeat, npay, rel);
      __syncthreads();   // the re-laid rows are in; the slot is free
      if (tid == 0) {
        fence_proxy_async();   // the slot's generic reads before the next copy
        issue();
        pstate[0] = pk;
        pstate[1] = prow;
      }
      // UNROLL pairs at a time: their alphas first (pairs whose box misses
      // the warp's quadrant skipped), then the running products in order;
      // the warp leaves once none of its pixels has T > 1e-4
      for (int j0 = 0; j0 < n && __any_sync(FULL, live()); j0 += UNROLL) {
        float al[UNROLL][PPT];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          // rows n .. (n rounded up to UNROLL) are culled
          const float4* row = rel + (j0 + u) * R4;
#pragma unroll
          for (int p = 0; p < PPT; ++p) al[u][p] = 0.f;
          if (culled(row[2], quad)) continue;
          const float4 g0 = row[0], g1 = row[1];
          const Powers<PPT> pw = pair_powers<PPT>(g0, g1, px, py);
#pragma unroll
          for (int p = 0; p < PPT; ++p) al[u][p] = fminf(__fmul_rn(g1.y, expf(pw.p[p])), ALPHA_MAX);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          bool cont[PPT], any = false;
#pragma unroll
          for (int p = 0; p < PPT; ++p) {
            cont[p] = al[u][p] >= ALPHA_MIN && T[p] > T_MIN;
            any |= cont[p];
          }
          if (!any) continue;
          const int j = j0 + u;
          float w[PPT];
#pragma unroll
          for (int p = 0; p < PPT; ++p) w[p] = al[u][p] * T[p];
#pragma unroll
          for (int q = 0; q < C::PAY4; ++q) {
            if (4 * q < npay) {
              const float4 p4 = rel[j * R4 + 3 + q];
              const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
#pragma unroll
                for (int p = 0; p < PPT; ++p)
                  if (4 * q + e < MAXP && cont[p]) acc[p][4 * q + e] += w[p] * pv[e];
              }
            }
          }
#pragma unroll
          for (int p = 0; p < PPT; ++p)
            if (cont[p]) T[p] *= 1.f - al[u][p], lst[p] = r0 - start + j + 1;
        }
      }
      // a barrier (the re-laid rows are consumed) and the unit's early exit
      if (__syncthreads_count(live()) == 0) {
        // drain the unit's stage in flight and issue no more of the unit
        const bool pending = pstate[0] == k && pstate[1] > r0 + n;
        __syncthreads();   // pstate is read before thread 0 moves on
        if (pending) {
          if (tid == 0) {
            prow = pend;
            mbar_wait(&bar, phase);
            issue();
          }
          phase ^= 1;
          // the drained phase is complete before anyone waits on the next
          // (a wait one phase ahead would pass at once)
          __syncthreads();
        }
        break;
      }
    }
    float* o = out + (size_t)t * (npay + 1) * NPIX;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int pix = pix0 + 4 * p * TILE;
#pragma unroll
      for (int c = 0; c < MAXP; ++c)
        if (c < npay) o[c * NPIX + pix] = acc[p][c];
      o[npay * NPIX + pix] = T[p];
      last[(size_t)t * NPIX + pix] = lst[p];
    }
  }
}

// A pixel's state in the backward walk: its upstream payload gradient, the
// transmittance after the current pair, the sum S and its last pair.
template <int MAXP>
struct BwdPixel {
  float gp[MAXP];
  float T, S;
  int lastc;

  __device__ __forceinline__ void load(const float* o, const float* go, const int* lt, int p,
                                       int npay) {
#pragma unroll
    for (int c = 0; c < MAXP; ++c) gp[c] = c < npay ? go[c * NPIX + p] : 0.f;
    T = o[npay * NPIX + p];
    S = T * go[npay * NPIX + p];
    lastc = lt[p];
  }

  // One contributing pair's terms added to v: dpow dx, dpow dy, dpow dx^2,
  // dpow dx dy, dpow dy^2 and dalpha g2d (the conic's and the mean's
  // gradients are formed from their sums over the warp, finish_term), and
  // w dL/dpayload.
  __device__ __forceinline__ void step(float* v, const float4* row, float dx, float dy,
                                       float g2d, float a0, int npay) {
    const float alpha = fminf(a0, ALPHA_MAX);
    const float r = __fdividef(1.f, 1.f - alpha);   // 1 - alpha in [0.001, 0.997)
    const float Tb = T * r;
    float G = 0.f;
#pragma unroll
    for (int q = 0; q < Cfg<MAXP>::PAY4; ++q) {
      if (4 * q < npay) {
        const float4 p = row[3 + q];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < MAXP) G += gp[4 * q + e] * pv[e];
      }
    }
    const float dalpha = Tb * G - S * r;
    const float w = alpha * Tb;
    S += w * G;
    T = Tb;
    if (a0 < ALPHA_MAX) {   // no gradient through the 0.999 clamp
      const float dpow = dalpha * a0, dpx = dpow * dx, dpy = dpow * dy;
      v[0] += dpx;
      v[1] += dpy;
      v[2] += dpx * dx;
      v[3] += dpx * dy;
      v[4] += dpy * dy;
      v[5] += dalpha * g2d;
    }
#pragma unroll
    for (int c = 0; c < MAXP; ++c) v[6 + c] += w * gp[c];
  }
};

// A pair's gradient term kl from the warp's sum of step's value kl (sum)
// and of the value beside it (other, kl ^ 1): d mux = a S0 + b S1, d muy =
// c S1 + b S0, d a = -S2 / 2, d b = -S3, d c = -S4 / 2 with S the sums of
// dpow dx, dpow dy, dpow dx^2, dpow dx dy, dpow dy^2; the rest as summed.
// (Selects, not branches: the lanes of a warp hold different kl.)
__device__ __forceinline__ float finish_term(int kl, float sum, float other, float4 g0,
                                             float c) {
  const float scale = kl == 0 ? g0.z : kl == 1 ? c : kl == 3 ? -1.f : kl < 5 ? -0.5f : 1.f;
  return scale * sum + (kl < 2 ? g0.w * other : 0.f);
}

template <int MAXP>
__global__ void __launch_bounds__(NT, 3)
composite_bwd(const float* __restrict__ feats, const int* __restrict__ bounds,
              const int* __restrict__ order, const int* __restrict__ tmax, int n_tiles,
              int tw, int npay, long long total16, const float* __restrict__ out,
              const int* __restrict__ last, const float* __restrict__ gout,
              float* __restrict__ dfeats) {
  using C = Cfg<MAXP>;
  constexpr int B = C::BWD_ROWS, R4 = C::R4, NF = C::NF, GP = C::GP;
  static_assert(NF % 2 == 0, "finish_term pairs terms 0 and 1 in lanes L and L ^ 1");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  const int nfeat = 6 + npay;
  float* raw = reinterpret_cast<float*>(smem);
  float4* rel = reinterpret_cast<float4*>(raw + slot_floats(B, nfeat));
  float* part = reinterpret_cast<float*>(rel + B * R4);   // NWARP x B x NF
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // lane L of a reduce-scatter holds term kl of pair jl of the group
  const int jl = lane / NF, kl = lane - jl * NF;

  // producer (thread 0): local tile pk (tile id ptile), rows pstart .. prow
  // still to issue, from the top down
  int pk = 0, ptile = -1, pstart = 0, prow = 0;
  auto issue = [&]() {
    while (ptile >= 0 && prow <= pstart) {
      ptile = block_tile(order, ++pk, n_tiles);
      if (ptile >= 0) pstart = bounds[ptile], prow = pstart + tmax[ptile];
    }
    if (ptile < 0) return;
    const int n = min(B, prow - pstart);
    prow -= n;
    issue_rows(raw, feats, prow, n, nfeat, total16, &bar);
  };
  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
    ptile = block_tile(order, 0, n_tiles);
    if (ptile >= 0) pstart = bounds[ptile], prow = pstart + tmax[ptile];
    issue();
  }
  __syncthreads();

  uint32_t phase = 0;
  for (int k = 0;; ++k) {
    const int t = block_tile(order, k, n_tiles);
    if (t < 0) break;
    const int start = bounds[t], maxl = tmax[t];
    // the rows no pixel reaches get a zero gradient
    float* zero = dfeats + (size_t)(start + maxl) * nfeat;
    for (int i = tid; i < (bounds[t + 1] - start - maxl) * nfeat; i += NT) zero[i] = 0.f;
    int pix0;
    float px, py[2];
    float4 quad;
    unit_pixels<2>(t, 0, tw, &pix0, &px, py, &quad);
    const float* o = out + (size_t)t * (npay + 1) * NPIX;
    const float* go = gout + (size_t)t * (npay + 1) * NPIX;
    const int* lt = last + (size_t)t * NPIX;
    BwdPixel<MAXP> q0, q1;
    q0.load(o, go, lt, pix0, npay);
    q1.load(o, go, lt, pix0 + 4 * TILE, npay);
    const int wmax = __reduce_max_sync(FULL, max(q0.lastc, q1.lastc));

    for (int hi = maxl; hi > 0; hi -= B) {
      const int lo = max(0, hi - B), n = hi - lo;
      mbar_wait(&bar, phase);
      phase ^= 1;
      relay_stage<MAXP>(raw + (((unsigned)(start + lo) * nfeat) & 3), n, n, nfeat, npay, rel);
      __syncthreads();   // the re-laid rows are in, the slot is free, the partials flushed
      if (tid == 0) {
        fence_proxy_async();
        issue();
      }
      float* pw = part + warp * B * NF;
      for (int jg = n - 1; jg >= 0; jg -= GP) {
        const int jrow = jg - jl;
        if (lo + jg - (GP - 1) >= wmax) {   // no pixel of the warp reaches the group
          if (jl < GP && jrow >= 0) pw[jrow * NF + kl] = 0.f;
          continue;
        }
        float v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) v[i] = 0.f;
        bool hit = false;
#pragma unroll
        for (int u = 0; u < GP; ++u) {
          const int j = jg - u;
          if (j < 0) continue;
          const float4* row = rel + j * R4;
          if (culled(row[2], quad)) continue;
          const float4 g0 = row[0], g1 = row[1];
          const Powers<2> p = pair_powers<2>(g0, g1, px, py);
          const float e0 = expf(p.p[0]), e1 = expf(p.p[1]);
          const float a00 = __fmul_rn(g1.y, e0), a01 = __fmul_rn(g1.y, e1);
          // the pixel's walk reaches the pair, and alpha >= 1/255
          const bool hit0 = lo + j < q0.lastc && fminf(a00, ALPHA_MAX) >= ALPHA_MIN;
          const bool hit1 = lo + j < q1.lastc && fminf(a01, ALPHA_MAX) >= ALPHA_MIN;
          if (hit0) q0.step(v + u * NF, row, p.dx, p.dy[0], e0, a00, npay);
          if (hit1) q1.step(v + u * NF, row, p.dx, p.dy[1], e1, a01, npay);
          hit |= hit0 || hit1;
        }
        if (__any_sync(FULL, hit)) {
          // NF is even: a pair's terms 0 and 1 sit in lanes L and L ^ 1
          const float sum = reduce_scatter32(v, lane);
          const float other = __shfl_xor_sync(FULL, sum, 1);
          if (jl < GP && jrow >= 0) {
            const float4* row = rel + jrow * R4;
            pw[jrow * NF + kl] = finish_term(kl, sum, other, row[0], row[1].x);
          }
        } else if (jl < GP && jrow >= 0) {
          pw[jrow * NF + kl] = 0.f;
        }
      }
      __syncthreads();   // the partials are in; the re-laid rows consumed
      float* dst = dfeats + (size_t)(start + lo) * nfeat;
      for (int i = tid; i < n * nfeat; i += NT) {
        const int j = i / nfeat, kf = i - j * nfeat;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NWARP; ++w) sum += part[(w * B + j) * NF + kf];
        dst[i] = sum;
      }
    }
  }
}

// Sorts the tiles into order (n_tiles) heaviest first, by work or, without
// it, by the pair counts of bounds.
cudaError_t launch_order(const int* bounds, const int* work, int n_tiles, int* order,
                         cudaStream_t stream) {
  const int blocks = (n_tiles + ORDER_TILES - 1) / ORDER_TILES;
  tile_order_kernel<<<blocks, ORDER_TILES * ORDER_SPLIT, 0, stream>>>(bounds, work, n_tiles,
                                                                      order);
  return cudaGetLastError();
}

// Blocks of the persistent grid: as many as fit on the SMs at once, at
// most one per tile. `cache` keeps a kernel's resident blocks by payload
// width; its first entry is set once the kernel may take `smem_max`, the
// shared memory of its widest payload.
template <typename K>
cudaError_t persistent_grid(K kernel, size_t smem, size_t smem_max, int npay,
                            int (&cache)[MAX_PAY + 1], int n_tiles, int* grid) {
  if (cache[0] == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (e != cudaSuccess) return e;
    cache[0] = 1;
  }
  if (cache[npay] == 0) {
    int per_sm = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
    if (e != cudaSuccess) return e;
    const int sms = mudg_host::sm_count();
    if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
    cache[npay] = per_sm * sms;
  }
  *grid = min(n_tiles, cache[npay]);
  return cudaSuccess;
}

// The forward takes halves of tiles (one pixel a thread) where both halves
// of every tile fit on the card at once, else whole tiles.
template <int MAXP>
cudaError_t launch_fwd(const float* feats, const int* bounds, int* order, float* out, int* last,
                       int n_tiles, int tw, int npay, long long total16, cudaStream_t stream) {
  static int cache1[MAX_PAY + 1] = {}, cache2[MAX_PAY + 1] = {};
  const size_t smem = fwd_smem<MAXP>(6 + npay), smem_max = fwd_smem<MAXP>(6 + MAXP);
  int grid = 0;
  cudaError_t e = persistent_grid(composite_fwd<MAXP, 1>, smem, smem_max, npay, cache1,
                                  2 * n_tiles, &grid);
  const bool halves = e == cudaSuccess && grid == 2 * n_tiles;
  if (e == cudaSuccess && !halves)
    e = persistent_grid(composite_fwd<MAXP, 2>, smem, smem_max, npay, cache2, n_tiles, &grid);
  if (e == cudaSuccess) e = launch_order(bounds, nullptr, n_tiles, order, stream);
  if (e != cudaSuccess) return e;
  if (halves)
    composite_fwd<MAXP, 1><<<grid, NT, smem, stream>>>(feats, bounds, order, n_tiles, tw, npay,
                                                        total16, out, last);
  else
    composite_fwd<MAXP, 2><<<grid, NT, smem, stream>>>(feats, bounds, order, n_tiles, tw, npay,
                                                        total16, out, last);
  return cudaGetLastError();
}

template <int MAXP>
cudaError_t launch_bwd(const float* feats, const int* bounds, int* order, const int* tmax,
                       const float* out, const int* last, const float* gout, float* dfeats,
                       int n_tiles, int tw, int npay, long long total16, cudaStream_t stream) {
  static int cache[MAX_PAY + 1] = {};
  const size_t smem = bwd_smem<MAXP>(6 + npay);
  int grid = 0;
  cudaError_t e = persistent_grid(composite_bwd<MAXP>, smem, bwd_smem<MAXP>(6 + MAXP), npay,
                                  cache, n_tiles, &grid);
  if (e == cudaSuccess) e = launch_order(nullptr, tmax, n_tiles, order, stream);
  if (e != cudaSuccess) return e;
  composite_bwd<MAXP><<<grid, NT, smem, stream>>>(feats, bounds, order, tmax, n_tiles, tw,
                                                   npay, total16, out, last, gout, dfeats);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mudg

// work (n) i32 -> order (n) i32: the indices heaviest first, ties by index
// (the order the kernels below take).
extern "C" int mudg_tile_order(const void* work, void* order, int n, void* stream) {
  if (n <= 0) return 0;
  return (int)mudg::launch_order(nullptr, static_cast<const int*>(work), n,
                                 static_cast<int*>(order), static_cast<cudaStream_t>(stream));
}

// feats (P, 6 + npay) f32 row-major, 16-byte aligned; bounds (n_tiles + 1)
// i32; order (n_tiles) i32 scratch (the tiles heaviest first by pair count
// are written there); out (n_tiles, npay + 1, 256) f32; last (n_tiles, 256)
// i32. 1 <= npay <= 26.
extern "C" int mudg_tile_composite(const void* feats, const void* bounds, void* order, void* out,
                                   void* last, int n_tiles, int tw, int npay, int n_rows,
                                   void* stream) {
  using namespace mudg;
  if (npay < 1 || npay > MAX_PAY) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const float* f = static_cast<const float*>(feats);
  const int* b = static_cast<const int*>(bounds);
  int* ord = static_cast<int*>(order);
  float* o = static_cast<float*>(out);
  int* l = static_cast<int*>(last);
  const long long total16 = ((long long)n_rows * (6 + npay) * 4) & ~15ll;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npay <= 4) return launch_fwd<4>(f, b, ord, o, l, n_tiles, tw, npay, total16, s);
  if (npay <= 8) return launch_fwd<8>(f, b, ord, o, l, n_tiles, tw, npay, total16, s);
  if (npay <= 16) return launch_fwd<16>(f, b, ord, o, l, n_tiles, tw, npay, total16, s);
  return launch_fwd<MAX_PAY>(f, b, ord, o, l, n_tiles, tw, npay, total16, s);
}

// order (n_tiles) i32 scratch (the tiles heaviest first by tmax); tmax
// (n_tiles) i32, each tile's largest `last`; out and last as the forward
// wrote them; gout like out; dfeats like feats (every row is written).
extern "C" int mudg_tile_composite_bwd(const void* feats, const void* bounds, void* order,
                                       const void* tmax, const void* out, const void* last,
                                       const void* gout, void* dfeats, int n_tiles, int tw,
                                       int npay, int n_rows, void* stream) {
  using namespace mudg;
  if (npay < 1 || npay > MAX_PAY) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const float* f = static_cast<const float*>(feats);
  const int* b = static_cast<const int*>(bounds);
  int* ord = static_cast<int*>(order);
  const int* tm = static_cast<const int*>(tmax);
  const float* o = static_cast<const float*>(out);
  const int* l = static_cast<const int*>(last);
  const float* g = static_cast<const float*>(gout);
  float* d = static_cast<float*>(dfeats);
  const long long total16 = ((long long)n_rows * (6 + npay) * 4) & ~15ll;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npay <= 4) return launch_bwd<4>(f, b, ord, tm, o, l, g, d, n_tiles, tw, npay, total16, s);
  if (npay <= 8) return launch_bwd<8>(f, b, ord, tm, o, l, g, d, n_tiles, tw, npay, total16, s);
  if (npay <= 16)
    return launch_bwd<16>(f, b, ord, tm, o, l, g, d, n_tiles, tw, npay, total16, s);
  return launch_bwd<MAX_PAY>(f, b, ord, tm, o, l, g, d, n_tiles, tw, npay, total16, s);
}
