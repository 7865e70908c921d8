// A weight gradient on TMA and wgmma: the sum over the rows of a batch
//   out(M, N) fp32 = A^T B = sum_r A[r, m] B[r, n],  A (K, M), B (K, N) bf16,
// with K the rows (tokens), used by kernel 10 (dW2 = dy^T h, dW1 = [du |
// dg]^T x) and kernel 9 (dWqkv' = dqkv^T xn, dWo = dy^T o). Both operands
// lie with the rows outermost; TMA loads 64-row K slabs of them as they
// lie, and wgmma reads both MN-major through its transpose bits (16-bit
// operands allow it), so nothing is transposed in software.
//
// Design: one block of 288 threads per 128 x 128 output tile and split of
// the rows. Warp 8 is the producer: one thread keeps a ring of WR_STAGES
// stages in flight, each the two 64-column boxes of A's 128 columns and
// B's, 64 rows deep. Both consumer warpgroups read every stage: warpgroup w
// multiplies A's box w by B's two boxes (two m64n64k16 products per k16
// step, each operand one 128-byte swizzle row wide, 64 fp32 accumulators a
// thread) and at the end of its split writes its 64 x 128 fp32 partial
// from registers. The rows are cut into at most 64 contiguous splits when
// the tiles alone leave SMs idle (the count the fewest whole waves of
// WR_WAVE blocks take, a function of the shapes alone); each split writes
// its own partial and a second pass adds them in split order (reduce.cuh).
// No atomics: the result is the same bit for bit from run to run. TMA's
// zero fill covers the rows past K and the columns past M and N.
#pragma once

#include "hopper.cuh"
#include "reduce.cuh"

namespace mudg {

constexpr int WR_STAGES = 6;
constexpr int WR_THREADS = 288;         // two consumer warpgroups + the producer warp
constexpr int WR_BOX = 64 * 128;        // bytes of a 64-row, 64-column bf16 box
constexpr int WR_STAGE = 4 * WR_BOX;    // A's two boxes, then B's two
constexpr int WR_SMEM = 1024 + WR_STAGES * WR_STAGE + 256;
// blocks of one wave on an H100 SXM (132 SMs, one block each): a constant,
// so that the split, and the order of the sums, depend on the shapes alone
constexpr int WR_WAVE = 132;

struct WgmmaWgradArgs {
  float* out;   // (M, N), or the (splits, M, N) partials
  int m, n;
  int slabs;    // 64-row K slabs in all
  int per;      // slabs per split
};

static __global__ void __launch_bounds__(WR_THREADS, 1)
    wgmma_wgrad_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, const WgmmaWgradArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WR_STAGES * WR_STAGE);
  uint64_t* empty = full + WR_STAGES;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const int s0 = blockIdx.z * p.per, ns = min(p.per, p.slabs - s0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < WR_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);   // both warpgroups read every stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {   // producer
    if (threadIdx.x == 256) {
      for (int i = 0; i < ns; ++i) {
        const int s = i % WR_STAGES, r = (s0 + i) * 64;
        if (i >= WR_STAGES) mbar_wait(&empty[s], ((i / WR_STAGES) - 1) & 1);
        uint8_t* st = ring + s * WR_STAGE;
        mbar_expect_tx(&full[s], WR_STAGE);
        tma_load_2d(st, &ta, &full[s], m0, r);
        tma_load_2d(st + WR_BOX, &ta, &full[s], m0 + 64, r);
        tma_load_2d(st + 2 * WR_BOX, &tb, &full[s], n0, r);
        tma_load_2d(st + 3 * WR_BOX, &tb, &full[s], n0 + 64, r);
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  float acc[2][32];   // output columns n0 .. + 63 and n0 + 64 .. + 127
  int prev = 0;
  for (int i = 0; i < ns; ++i) {
    const int s = i % WR_STAGES;
    mbar_wait(&full[s], (i / WR_STAGES) & 1);
    uint8_t* st = ring + s * WR_STAGE;
    const uint64_t da = sw128_desc(st + cw * WR_BOX), db = sw128_desc(st + 2 * WR_BOX);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int hn = 0; hn < 2; ++hn)
        wgmma_ss_n64_tt(acc[hn], da + kk * MNMAJOR_K16,
                        db + hn * (WR_BOX >> 4) + kk * MNMAJOR_K16, i > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done: it is free
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (i > 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // output rows m0 + 64 cw + 16 warp + g (+ 8), columns n0 + 64 hn + 8 j + 2 qd
  float* out = p.out + (size_t)blockIdx.z * p.m * p.n;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + 64 * cw + 16 * warp + g + 8 * hh;
    if (row >= p.m) continue;
#pragma unroll
    for (int hn = 0; hn < 2; ++hn)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + 64 * hn + 8 * j + 2 * qd;
        if (col < p.n)
          *reinterpret_cast<float2*>(out + (size_t)row * p.n + col) =
              make_float2(acc[hn][4 * j + 2 * hh], acc[hn][4 * j + 2 * hh + 1]);
      }
  }
}

// The split count for `tiles` output tiles over `slabs` K slabs: the one
// whose blocks finish in the least time in whole waves of WR_WAVE (waves x
// slabs per split), each split at least 8 slabs deep, its partials within
// work_elems; the fewest splits of equal time.
static inline int wgmma_wgrad_splits(int tiles, int slabs, long long mn, long long work_elems) {
  int best = 1;
  long long best_cost = (long long)((tiles + WR_WAVE - 1) / WR_WAVE) * slabs;
  for (int s = 2; s <= 64 && 8 * s <= slabs && (long long)s * mn <= work_elems; ++s) {
    const long long per = (slabs + s - 1) / s;
    const long long cost = (((long long)tiles * s + WR_WAVE - 1) / WR_WAVE) * per;
    if (cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// out (m, n) fp32 = a^T b over k rows: a (k, m) with row pitch lda, b (k, n)
// with pitch ldb, bf16 (pitches multiples of 8 elements, pointers 16-byte
// aligned, n even); partials in `work` (work_elems fp32).
static inline cudaError_t launch_wgmma_wgrad(const bf16* a, long long lda, const bf16* b,
                                             long long ldb, int m, int n, int k, float* out,
                                             float* work, long long work_elems,
                                             cudaStream_t st) {
  using mudg_host::bf16_matrix_map;
  thread_local bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(wgmma_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WR_SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  if (m < 1 || n < 1 || k < 1 || n % 2) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t e = bf16_matrix_map(&ta, a, k, m, lda, 64);
  if (e == cudaSuccess) e = bf16_matrix_map(&tb, b, k, n, ldb, 64);
  if (e != cudaSuccess) return e;
  const int gm = (m + 127) / 128, gn = (n + 127) / 128, slabs = (k + 63) / 64;
  int splits = wgmma_wgrad_splits(gm * gn, slabs, (long long)m * n, work_elems);
  const int per = (slabs + splits - 1) / splits;
  splits = (slabs + per - 1) / per;   // every split holds at least one slab
  const WgmmaWgradArgs p = {splits > 1 ? work : out, m, n, slabs, per};
  wgmma_wgrad_kernel<<<dim3(gn, gm, splits), WR_THREADS, WR_SMEM, st>>>(ta, tb, p);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return launch_split_sum(work, splits, (long long)m * n, out, st);
}

}  // namespace mudg
