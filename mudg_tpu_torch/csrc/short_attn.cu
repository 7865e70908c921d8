// Kernel 12, packed form: self-attention over each (b, h) sequence of q, k,
// v (B, T, H, D) bf16 on its own, non-causal, T in {1, 2, 4, .., 64}, head
// dim D = 64 or 128:
//   o = softmax(q k^T / sqrt(D)) v   per sequence,
// fp32 logits scaled after the product, an fp32 softmax, P normalised and
// then rounded to bf16 for P V (short_attention.py:_packed_kernel, :60-71).
//
// Replaces: mudg_tpu/kernels/short_attention.py:_packed_kernel
// (packed_short_attention, pallas_call at :81).
//
// Bound on this card: bytes. At T = 16 a sequence's logits are 16 x 16 x
// D: 2 x 16 x 16 x 64 x 2 = 65.5 kFLOP against 8 KB of q, k, v and o, about
// 8 operations a byte where the tensor cores need ~295 to be the limit.
// The three temporal shapes of MDM512 move 367 MB (0.110 ms at 3.35 TB/s).
//
// Design: for the copy engine, not the math. The TPU packs 128 // T
// sequences into one 128-row block-diagonal product to fill its MXU; none
// of that is done here (no packing copies, no G-fold overcompute).
// - Work items: in (B, T, H, D) the T x H x D slab of one batch row is
//   contiguous, so an item is a box of (D, hg heads, T rows, bg batch rows)
//   of each of q, k and v (kernels/short_attention.packed_plan picks hg
//   and bg: whole sequences, at most 16 KB a tensor, a multiple of 16 rows),
//   read through a 4-D tensor map (D, H, T, B) with the tensors' own strides
//   (q, k and v may be strided views of one q|k|v projection).
// - One persistent block per SM walks the items (item blockIdx.x + i *
//   gridDim.x). Warp 8 is the producer: one thread keeps a ring of
//   `stages` items in flight by TMA (one full and one done mbarrier per
//   stage), so the next items' loads overlap this item's products.
// - Warps 0-7 take the item's 16-row tiles round robin across items (tile
//   j of item i goes to warp (i * tiles + j) % 8). A tile is 16 query rows
//   of one sequence (T >= 16), or 16 / T whole sequences (T < 16, the
//   other sequences' keys masked: the least an m16n8k16 tile takes). Its q
//   rows and its keys are gathered by ldmatrix from the swizzled box, where
//   one sequence's rows lie hg rows apart (V through ldmatrix.trans: no
//   thread transposes anything); S = Q K^T and O = P V run on mma.sync
//   m16n8k16 (bf16 in, fp32 accumulate). wgmma takes 64 rows, and one
//   sequence's 16 x 16 logits would be a sixteenth of its tile.
// - Each warp writes its tile's o rows (bf16) over its own q rows in the
//   stage (read into registers before), behind an async-proxy fence, and
//   arrives on the stage's done barrier; the producer then stores the item's
//   o box by TMA, waits for the store to read the stage and loads the next
//   item into it.
#include "hopper.cuh"

namespace mudg {

constexpr int PK_CONSUMERS = 8;                      // consumer warps
constexpr int PK_THREADS = 32 * (PK_CONSUMERS + 1);  // + the producer warp

struct PackedArgs {
  int items;      // (head group, batch group) items in all
  int hgroups;    // head groups per batch row: item = bgroup * hgroups + hgroup
  int hg, bg;     // heads and batch rows per item
  int rows;       // rows per item: bg * T * hg, a multiple of 16
  int stages;     // items in flight per block
  float scale;    // d^-0.5 * log2(e): logits in base 2, scaled in fp32
};

// Shared address of 16-byte chunk c (8 columns) of row r of a tensor's box
// in a stage: D / 64 column boxes of `rows` swizzled 128-byte rows.
__device__ __forceinline__ uint32_t pk_chunk(uint32_t base, int r, int c, int rows) {
  return base + (uint32_t)((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// The box row of row `vr` of an item in sequence order (sequence vr / T,
// position vr % T), with the box laid out (batch row, position, head).
template <int T>
__device__ __forceinline__ int pk_row(int vr, int hg) {
  const int seq = vr / T, t = vr % T;
  return ((seq / hg) * T + t) * hg + seq % hg;
}

// One 16-row tile j of the item in the stage at q, k, v (shared addresses):
// o over the tile's own q rows.
template <int D, int T>
__device__ __forceinline__ void pk_tile(uint32_t q, uint32_t k, uint32_t v, int j,
                                        const PackedArgs& p, int lane) {
  constexpr int NK = T >= 16 ? T : 16;  // keys a tile attends (one tile at least)
  const int g = lane >> 2, qd = lane & 3, m = lane >> 3;
  const int key0 = T >= 16 ? (16 * j / T) * T : 16 * j;

  // Q fragments: matrix m holds rows 8 (m & 1) .., columns 8 (m >> 1) .. of a k16 step
  uint32_t qf[D / 16][4];
  {
    const int r = pk_row<T>(16 * j + (lane & 7) + 8 * (m & 1), p.hg);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], pk_chunk(q, r, 2 * kk + (m >> 1), p.rows));
  }
  // S = Q K^T: a pair of n8 tiles (16 keys) per ldmatrix, matrix m holding
  // keys 8 (m >> 1) .., columns 8 (m & 1) .. of the k16 step
  float s[NK / 8][4];
#pragma unroll
  for (int nj = 0; nj < NK / 8; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nj][e] = 0.f;
#pragma unroll
  for (int np = 0; np < NK / 16; ++np) {
    const int r = pk_row<T>(key0 + 16 * np + 8 * (m >> 1) + (lane & 7), p.hg);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, pk_chunk(k, r, 2 * kk + (m & 1), p.rows));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_16816(s[2 * np], qf[kk], b0);
      mma_16816(s[2 * np + 1], qf[kk], b1);
    }
  }
  // scale in fp32, mask other sequences' keys (T < 16), softmax over the
  // NK keys of rows g and g + 8, P normalised before its bf16 rounding
#pragma unroll
  for (int nj = 0; nj < NK / 8; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), col = 8 * nj + 2 * qd + (e & 1);
      s[nj][e] = (T >= 16 || row / T == col / T) ? s[nj][e] * p.scale : -INFINITY;
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int nj = 0; nj < NK / 8; ++nj) mx = fmaxf(mx, fmaxf(s[nj][2 * hh], s[nj][2 * hh + 1]));
    mx = quad_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int nj = 0; nj < NK / 8; ++nj) {
      s[nj][2 * hh] = exp2f(s[nj][2 * hh] - mx);
      s[nj][2 * hh + 1] = exp2f(s[nj][2 * hh + 1] - mx);
      sum += s[nj][2 * hh] + s[nj][2 * hh + 1];
    }
    const float inv = 1.f / quad_sum(sum);
#pragma unroll
    for (int nj = 0; nj < NK / 8; ++nj) {
      s[nj][2 * hh] *= inv;
      s[nj][2 * hh + 1] *= inv;
    }
  }
  // O = P V: V^T fragments by ldmatrix.trans, matrix m holding keys 8 (m &
  // 1) .. of the k16 step, columns 8 (m >> 1) .. of a pair of n8 tiles
  float o[D / 8][4];
#pragma unroll
  for (int dj = 0; dj < D / 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dj][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const int r = pk_row<T>(key0 + 16 * kk + 8 * (m & 1) + (lane & 7), p.hg);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, pk_chunk(v, r, 2 * dp + (m >> 1), p.rows));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_16816(o[2 * dp], a, b0);
      mma_16816(o[2 * dp + 1], a, b1);
    }
  }
  // o over this tile's q rows (no other warp reads them)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = pk_row<T>(16 * j + g + 8 * hh, p.hg);
#pragma unroll
    for (int dj = 0; dj < D / 8; ++dj) {
      const uint32_t addr = pk_chunk(q, r, dj, p.rows) + 4 * qd;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                   "r"(pack_bf16x2(o[dj][2 * hh], o[dj][2 * hh + 1]))
                   : "memory");
    }
  }
}

// The item's boxes of one tensor (D / 64 column boxes) into dst, or from
// src to the output's map.
template <int D>
__device__ __forceinline__ void pk_load(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                        int h0, int b0, int rows) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) tma_load_4d(dst + cb * rows * 128, map, bar, 64 * cb, h0, 0, b0);
}

template <int D>
__device__ __forceinline__ void pk_store(const CUtensorMap* map, const uint8_t* src, int h0,
                                         int b0, int rows) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) tma_store_4d(map, src + cb * rows * 128, 64 * cb, h0, 0, b0);
}

template <int D, int T>
__global__ void __launch_bounds__(PK_THREADS, 1)
    packed_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                  const PackedArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  const int tb = p.rows * D * 2;  // bytes of one tensor's box
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * 3 * tb);
  uint64_t* done = full + p.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = p.items > (int)blockIdx.x ? (p.items - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&done[s], PK_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == PK_CONSUMERS) {  // producer
    if (lane == 0) {
      for (int i = 0; i < n + p.stages; ++i) {
        const int s = i % p.stages;
        if (i >= p.stages) {  // the item that used this stage is done: store its o
          const int it = blockIdx.x + (i - p.stages) * gridDim.x;
          mbar_wait(&done[s], ((i / p.stages) - 1) & 1);
          pk_store<D>(&to, ring + s * 3 * tb, (it % p.hgroups) * p.hg, (it / p.hgroups) * p.bg,
                      p.rows);
          bulk_commit();
          if (i < n) bulk_wait_read<0>();  // the stage is read before it is loaded again
        }
        if (i < n) {
          const int it = blockIdx.x + i * gridDim.x;
          const int h0 = (it % p.hgroups) * p.hg, b0 = (it / p.hgroups) * p.bg;
          uint8_t* st = ring + s * 3 * tb;
          mbar_expect_tx(&full[s], 3 * tb);
          pk_load<D>(st, &tq, &full[s], h0, b0, p.rows);
          pk_load<D>(st + tb, &tk, &full[s], h0, b0, p.rows);
          pk_load<D>(st + 2 * tb, &tv, &full[s], h0, b0, p.rows);
        }
      }
      bulk_wait<0>();
    }
    return;
  }

  const int tiles = p.rows / 16;
  for (int i = 0; i < n; ++i) {
    const int s = i % p.stages;
    mbar_wait(&full[s], (i / p.stages) & 1);
    // tiles <= 8 = PK_CONSUMERS: this warp takes at most one of the item's
    const int j = (warp + PK_CONSUMERS - (i * tiles) % PK_CONSUMERS) % PK_CONSUMERS;
    if (j < tiles) {
      const uint32_t q = smem_addr(ring + s * 3 * tb);
      pk_tile<D, T>(q, q + tb, q + 2 * tb, j, p, lane);
      fence_proxy_async();  // o (generic writes) is read by the TMA store; the stage refilled
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&done[s]);
  }
}

template <int D, int T>
static cudaError_t launch_packed(const CUtensorMap* maps, const PackedArgs& p, int grid,
                                 int smem, cudaStream_t s) {
  thread_local int allowed = 0;  // the dynamic shared memory this kernel was allowed so far
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(packed_kernel<D, T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  packed_kernel<D, T><<<grid, PK_THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_packed_t(int t, const CUtensorMap* maps, const PackedArgs& p,
                                   int grid, int smem, cudaStream_t s) {
  switch (t) {
    case 1: return launch_packed<D, 1>(maps, p, grid, smem, s);
    case 2: return launch_packed<D, 2>(maps, p, grid, smem, s);
    case 4: return launch_packed<D, 4>(maps, p, grid, smem, s);
    case 8: return launch_packed<D, 8>(maps, p, grid, smem, s);
    case 16: return launch_packed<D, 16>(maps, p, grid, smem, s);
    case 32: return launch_packed<D, 32>(maps, p, grid, smem, s);
    case 64: return launch_packed<D, 64>(maps, p, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mudg

using namespace mudg;

// Shared memory of a packed launch: the ring and its barriers, 1024-aligned
// (kernels/short_attention.packed_plan computes the same).
static int packed_smem(int rows, int d, int stages) {
  return 1024 + stages * 3 * rows * d * 2 + stages * 16;
}

// q, k, v (batch, t, heads, d) bf16 with the given element strides (the head
// dim contiguous, every stride a multiple of 8, 16-byte aligned pointers);
// o (batch, t, heads, d) bf16 contiguous. d = 64 or 128, t in {1, 2, 4, ..,
// 64}. The launch plan (kernels/short_attention.packed_plan): items of hg
// heads by bg batch rows (rows = bg * t * hg a multiple of 16, at most 8
// tiles), `stages` items in flight, `grid` persistent blocks.
extern "C" int mudg_packed_attn(const void* q, const void* k, const void* v, void* o,
                                int batch, int t, int heads, int d, int hg, int bg, int stages,
                                int grid, long long q_sb, long long q_sl, long long q_sh,
                                long long k_sb, long long k_sl, long long k_sh,
                                long long v_sb, long long v_sl, long long v_sh, void* stream) {
  const int rows = bg * t * hg;
  if ((d != 64 && d != 128) || t < 1 || t > 64 || batch < 1 || heads < 1 || hg < 1 || bg < 1 ||
      hg > 256 || bg > 256 || rows % 16 || rows > 128 || stages < 2 || grid < 1 ||
      packed_smem(rows, d, stages) > 232448)
    return cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                            (long long)t * heads * d, (long long)heads * d, d};
  const void* base[4] = {q, k, v, o};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)t,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)st[3 * i + 2] * 2, (cuuint64_t)st[3 * i + 1] * 2,
                                   (cuuint64_t)st[3 * i] * 2};
    const cuuint32_t box[4] = {64, (cuuint32_t)hg, (cuuint32_t)t, (cuuint32_t)bg};
    const cudaError_t e = mudg_host::bf16_map(&maps[i], base[i], 4, dims, strides, box);
    if (e != cudaSuccess) return e;
  }
  PackedArgs p;
  p.hg = hg;
  p.bg = bg;
  p.hgroups = (heads + hg - 1) / hg;
  p.items = p.hgroups * ((batch + bg - 1) / bg);
  p.rows = rows;
  p.stages = stages;
  p.scale = 1.4426950408889634f / sqrtf((float)d);
  const int smem = packed_smem(rows, d, stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_packed_t<64>(t, maps, p, grid, smem, s)
                 : launch_packed_t<128>(t, maps, p, grid, smem, s);
}
