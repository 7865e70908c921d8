// A warp-specialised, persistent bf16 GEMM for Hopper on TMA and wgmma, with
// fp32 accumulation and a fused epilogue:
//   out(M, N) = epilogue(A(M, K) @ B(N, K)^T),
// A and B row-major with K contiguous (B is the torch layout of a Linear
// weight (out, in), used as it is loaded).
//
// Epilogues (the output is bf16):
//   WG_BIAS      acc + bias[col] (a null bias is zero: the launcher points it
//                at WG_ZEROS zeros in device memory; a null test in the
//                epilogue, or an epilogue without the bias, made ptxas spill
//                ~600 bytes a thread at the 168-register cap)
//   WG_BIAS_RES  acc + bias[col] + res[row, col] (res read by TMA)
//   WG_GEGLU     u * gelu_erf(g), u = acc over B rows [n0, n0 + 64) +
//                bias[col], g = acc over B rows [gate + n0, ..) +
//                bias[gate + col]: each K slab of B holds the 64 value rows
//                and the 64 matching gate rows, one n128 product gives both
//                to the same thread, and only the (M, gate) product
//                u * gelu(g) reaches device memory.
//
// Design: one block of 288 threads per SM walks output tiles of 128 rows x
// WG_TN columns (128, or 64 h columns for WG_GEGLU; tile t: row block t /
// n_tiles, column block t % n_tiles, so the blocks resident at one time
// share their A rows in L2). Warp 8 is the producer: one thread keeps a
// ring of STAGES K slabs in flight, each 64 columns of K (one 128-byte
// swizzle row of bf16) of the 128-row A tile and the 128-row B tile,
// loaded by TMA with one full and one empty mbarrier per stage. The two
// consumer warpgroups take alternate tiles of the block (ping-pong): each
// multiplies its tile's slabs by m64n128k16 wgmma (two 64-row halves, both
// operands from shared memory), one slab's products left in flight while
// the next slab is awaited; since the producer fills the ring in tile
// order, one warpgroup's products run while the other runs its epilogue
// (the GEGLU's erf is about 40% of the products' time at the tensor cores'
// peak, so it has to overlap them). The epilogue runs in registers; the
// warpgroup writes its 128-row result, swizzled, to its own staging tile
// in shared memory and one thread stores it with TMA as whole 128-byte rows
// (the residual arrives the same way, loaded when the tile starts). TMA's
// zero fill covers the K tail and the M and N tails of the loads, and its
// stores clip the M and N tails, so any M, any K % 8 == 0 and any N % 8 ==
// 0 run (N % 64 == 0 and gate % 64 == 0 for WG_GEGLU).
//
// Sources (where A, B and the output come from):
//   WG_MATRIX  row-major matrices through 2-D tensor maps, as above.
//   WG_TAP3    the (3, 1, 1) temporal convolution of a video h (B, T, HW,
//              C) as one GEMM with K = 3 taps x C: A's row r of frame (b,
//              t) over tap tau's C columns is h[b, t + tau - 1, r], B is the
//              packed weight wcat (C_out, 3, C_in). A comes through a 4-D map
//              (C, HW, T, B): a tile is 128 rows of HW inside one frame, and
//              for tap tau it loads frame t + tau - 1, which TMA fills with
//              zeros where it falls outside [0, T), so the zero fill is the
//              conv's padding and a tile never reads a neighbouring clip's
//              frame. B comes through a 3-D map (C_in, 3, C_out), so a tap's
//              last K slab at C_in % 64 != 0 is zero-filled and does not read
//              the next tap's columns. The output leaves through the 4-D map
//              of A's shape (the HW tail clipped on the store). Tiles walk
//              (b, t, HW block) with the column blocks innermost, so any HW
//              runs.
#pragma once

#include "hopper.cuh"

namespace mudg {

enum { WG_BIAS = 0, WG_BIAS_RES = 1, WG_GEGLU = 2 };
enum { WG_MATRIX = 0, WG_TAP3 = 1 };

constexpr int WG_BM = 128;                 // tile rows
constexpr int WG_THREADS = 288;            // two consumer warpgroups + the producer warp
constexpr int WG_SLAB = 128 * 128;         // bytes of a 128-row K slab (of A or of B)
constexpr int WG_STAGE = 2 * WG_SLAB;      // A and B

// output columns of a tile
__host__ __device__ constexpr int wg_tn(int epi) { return epi == WG_GEGLU ? 64 : 128; }
__host__ __device__ constexpr int wg_stages(int epi) { return epi == WG_GEGLU ? 6 : 5; }
// bytes of a warpgroup's staging tile: 128 rows x wg_tn bf16
__host__ __device__ constexpr int wg_staging(int epi) { return WG_BM * wg_tn(epi) * 2; }
// the ring, two staging tiles, the barriers, and slack to align to 1024
__host__ __device__ constexpr int wg_smem(int epi) {
  return 1024 + wg_stages(epi) * WG_STAGE + 2 * wg_staging(epi) + 256;
}

struct WgGemmArgs {
  const float* bias;   // fp32: (N) or, for WG_GEGLU, (2 * gate)
  int n;               // output columns (= gate for WG_GEGLU)
  int nk;              // 64-column K slabs per tile
  int gate;            // WG_GEGLU: first B row of the gate half
  int n_tiles, tiles;  // column blocks, all tiles
  // WG_TAP3: frames per clip, 128-row tiles per frame, K slabs per tap
  int frames, hw_tiles, kc;
};

// Where tile t's rows lie: m0 for WG_MATRIX; the first row hw0 of HW, the
// frame t and the clip b for WG_TAP3 (row block mt = (b * T + t) *
// hw_tiles + hw0 / 128).
struct WgRows {
  int m0, hw0, t, b;
};

template <int SRC>
__device__ __forceinline__ WgRows wg_rows(const WgGemmArgs& p, int mt) {
  WgRows r;
  r.m0 = mt * WG_BM;
  if (SRC == WG_TAP3) {
    const int frame = mt / p.hw_tiles;
    r.hw0 = (mt - frame * p.hw_tiles) * WG_BM;
    r.t = frame % p.frames;
    r.b = frame / p.frames;
  }
  return r;
}

__device__ __forceinline__ float gelu_erf(float g) {
  return g * 0.5f * (1.f + erff(g * 0.70710678118654752f));
}

template <int EPI, int SRC>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tout,
                      const __grid_constant__ CUtensorMap tres, const WgGemmArgs p) {
  constexpr int S = wg_stages(EPI), TN = wg_tn(EPI);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint8_t* staging = ring + S * WG_STAGE;   // per consumer warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * wg_staging(EPI));
  uint64_t* empty = full + S;
  uint64_t* res_bar = empty + S;      // per consumer warpgroup
  const int nk = p.nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);   // a stage is read by the warpgroup of its tile
    }
    mbar_init(&res_bar[0], 1);
    mbar_init(&res_bar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer: every tile's slabs, in tile order
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const WgRows rw = wg_rows<SRC>(p, t / p.n_tiles);
        const int n0 = (t % p.n_tiles) * TN;
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
          uint8_t* st = ring + s * WG_STAGE;
          mbar_expect_tx(&full[s], WG_STAGE);
          if (SRC == WG_TAP3) {   // tap tau = ks / kc reads frame t + tau - 1
            const int tap = ks / p.kc, k0 = (ks - tap * p.kc) * 64;
            tma_load_4d(st, &ta, &full[s], k0, rw.hw0, rw.t + tap - 1, rw.b);
            tma_load_3d(st + WG_SLAB, &tb, &full[s], k0, tap, n0);
            continue;
          }
          tma_load_2d(st, &ta, &full[s], ks * 64, rw.m0);
          if (EPI == WG_GEGLU) {   // 64 value rows, then the 64 gate rows
            tma_load_2d(st + WG_SLAB, &tb, &full[s], ks * 64, n0);
            tma_load_2d(st + WG_SLAB + WG_SLAB / 2, &tb, &full[s], ks * 64, p.gate + n0);
          } else {
            tma_load_2d(st + WG_SLAB, &tb, &full[s], ks * 64, n0);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw takes the block's tiles i = cw, cw + 2, ..
  // A warpgroup waits for a tile's slabs only once the other has waited for
  // all of the previous tile's (named barriers 3 and 4, in turns): a wait on
  // an mbarrier more than one phase ahead of it would pass at once.
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  uint8_t* stg = staging + cw * wg_staging(EPI);
  const int ntiles = (p.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  float acc[2][64];   // rows 0-63 and 64-127 of the tile
  if (cw == 1) named_bar_arrive(3, 256);   // warpgroup 0 takes tile 0 at once
  int j = 0;
  for (int i = cw; i < ntiles; i += 2, ++j) {
    const int t = blockIdx.x + i * gridDim.x;
    named_bar_sync(3 + cw, 256);
    const WgRows rw = wg_rows<SRC>(p, t / p.n_tiles);
    const int n0 = (t % p.n_tiles) * TN;
    // 64-column boxes of this tile that hold output columns (N tail)
    const int boxes = min(TN / 64, (p.n - n0 + 63) / 64);
    if (EPI == WG_BIAS_RES && tid == 0) {
      // the staging tile is free once the last store has read it; the
      // residual lands there while the products run
      bulk_wait_read<0>();
      mbar_expect_tx(&res_bar[cw], boxes * WG_BM * 128);
      for (int bx = 0; bx < boxes; ++bx)
        tma_load_2d(stg + bx * WG_BM * 128, &tres, &res_bar[cw], n0 + 64 * bx, rw.m0);
    }

    int it = i * nk, prev = 0;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      if (ks == nk - 1) named_bar_arrive(4 - cw, 256);   // the other's turn to wait
      uint8_t* st = ring + s * WG_STAGE;
      const uint64_t da = sw128_desc(st), db = sw128_desc(st + WG_SLAB);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int hm = 0; hm < 2; ++hm)
          wgmma_ss_n128(acc[hm], da + (hm * 64 * 128 >> 4) + kk * KMAJOR_K16,
                        db + kk * KMAJOR_K16, ks > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slab's products are done: its stage is free
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (ks > 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    mbar_arrive(&empty[prev]);

    // epilogue: registers -> staging (swizzled) -> TMA store
    if (EPI != WG_BIAS_RES && tid == 0) bulk_wait_read<0>();
    named_bar_sync(1 + cw, 128);
    if (EPI == WG_BIAS_RES) mbar_wait(&res_bar[cw], j & 1);
    // column pair (c, c + 1) of this thread, its biases read once for the
    // four rows that hold it
#pragma unroll
    for (int jj = 0; jj < TN / 8; ++jj) {
      const int c = 8 * jj + 2 * qd, col = n0 + c;
      const bool live = EPI == WG_GEGLU || col < p.n;
      const float2 bv = live ? *reinterpret_cast<const float2*>(p.bias + col)
                             : make_float2(0.f, 0.f);
      float2 bg = make_float2(0.f, 0.f);
      if (EPI == WG_GEGLU) bg = *reinterpret_cast<const float2*>(p.bias + p.gate + col);
#pragma unroll
      for (int hm = 0; hm < 2; ++hm) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 64 * hm + 16 * warp + g + 8 * hh;
          uint32_t* dst = reinterpret_cast<uint32_t*>(stg + sw128_offset(r, c, WG_BM));
          float v0 = acc[hm][4 * jj + 2 * hh] + bv.x, v1 = acc[hm][4 * jj + 2 * hh + 1] + bv.y;
          if (EPI == WG_GEGLU) {   // the gate of column c is accumulator column 64 + c
            v0 *= gelu_erf(acc[hm][4 * (jj + 8) + 2 * hh] + bg.x);
            v1 *= gelu_erf(acc[hm][4 * (jj + 8) + 2 * hh + 1] + bg.y);
          } else if (EPI == WG_BIAS_RES && live) {
            const float2 x = unpack_bf16x2(*dst);
            v0 += x.x;
            v1 += x.y;
          }
          *dst = pack_bf16x2(v0, v1);
        }
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);
    if (tid == 0) {
      for (int bx = 0; bx < boxes; ++bx) {
        if (SRC == WG_TAP3)
          tma_store_4d(&tout, stg + bx * WG_BM * 128, n0 + 64 * bx, rw.hw0, rw.t, rw.b);
        else
          tma_store_2d(&tout, stg + bx * WG_BM * 128, n0 + 64 * bx, rw.m0);
      }
      bulk_commit();
    }
  }
  // the other warpgroup's arrival after its last tile, where no tile of
  // this one took it
  if (cw == 0 && ntiles % 2 == 0) named_bar_sync(3, 256);
  if (cw == 1 && ntiles % 2 == 1) named_bar_sync(4, 256);
  if (tid == 0) bulk_wait<0>();
}

// The bias of a WG_BIAS product without one.
constexpr int WG_ZEROS = 4096;
static __device__ float wg_zeros[WG_ZEROS] = {};

// Launches the kernel on persistent blocks, one per SM or one per tile
// where there are fewer tiles; p.tiles and p.n_tiles set.
template <int EPI, int SRC>
static inline cudaError_t wg_launch(const CUtensorMap& ta, const CUtensorMap& tb,
                                    const CUtensorMap& tout, const CUtensorMap& tres,
                                    const WgGemmArgs& p, cudaStream_t stream) {
  // the dynamic shared-memory limit is raised once per host thread (a
  // launch from a thread that has not raised it is refused)
  thread_local bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(wgmma_gemm_kernel<EPI, SRC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wg_smem(EPI));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int sms = mudg_host::sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int grid = p.tiles < sms ? p.tiles : sms;
  wgmma_gemm_kernel<EPI, SRC><<<grid, WG_THREADS, wg_smem(EPI), stream>>>(ta, tb, tout, tres, p);
  return cudaGetLastError();
}

// out = epilogue(A @ B^T). a: (m, k) with row pitch lda, b: (rows_b, k)
// with pitch ldb (rows_b = n, or 2 * gate for WG_GEGLU), out: (m, n) with
// pitch ldo, res: (m, n) with pitch ldr (WG_BIAS_RES); bias null for none
// (WG_BIAS, n <= WG_ZEROS). Pitches are multiples of 8 elements, pointers
// 16-byte aligned.
template <int EPI>
static inline cudaError_t launch_wgmma_gemm(const bf16* a, long long lda, const bf16* b,
                                            long long ldb, bf16* out, long long ldo,
                                            const bf16* res, long long ldr, const float* bias,
                                            int m, int n, int k, int gate,
                                            cudaStream_t stream) {
  using mudg_host::bf16_matrix_map;
  const bool geglu = EPI == WG_GEGLU;
  CUtensorMap ta, tb, tout, tres;
  cudaError_t e = bf16_matrix_map(&ta, a, m, k, lda, WG_BM);
  if (e == cudaSuccess) e = bf16_matrix_map(&tb, b, geglu ? 2 * gate : n, k, ldb, geglu ? 64 : 128);
  if (e == cudaSuccess) e = bf16_matrix_map(&tout, out, m, n, ldo, WG_BM);
  if (e == cudaSuccess) e = bf16_matrix_map(&tres, res != nullptr ? res : out, m, n,
                                            res != nullptr ? ldr : ldo, WG_BM);
  if (e != cudaSuccess) return e;
  if (bias == nullptr) {   // the current device's copy of wg_zeros
    if (EPI != WG_BIAS || n > WG_ZEROS) return cudaErrorInvalidValue;
    void* zeros = nullptr;
    e = cudaGetSymbolAddress(&zeros, wg_zeros);
    if (e != cudaSuccess) return e;
    bias = static_cast<const float*>(zeros);
  }
  WgGemmArgs p = {};
  p.bias = bias;
  p.n = n;
  p.nk = (k + 63) / 64;
  p.gate = gate;
  p.n_tiles = (n + wg_tn(EPI) - 1) / wg_tn(EPI);
  p.tiles = ((m + WG_BM - 1) / WG_BM) * p.n_tiles;
  return wg_launch<EPI, WG_MATRIX>(ta, tb, tout, tres, p, stream);
}

}  // namespace mudg
