// Kernel 12, short-KV form, bf16 at head dim 64 and Lk <= 128 (every MuDG
// site: the UNet's text and image cross-attention, Lk = 77 and 16):
//   o = softmax(q k^T / 8) v,  q (B, Lq, H, 64) over k, v (B, Lk, H, 64),
// fp32 logits and softmax, P normalised and then rounded to bf16 for P V,
// as the reference does (short_attention.py:174-180: p / sum, then
// astype(v.dtype)). The fp32 form at these shapes is short_kv_f32.cu; the
// other shapes the predicate admits (Lk up to 1024, head dim 128) stay on
// short_attn.cu's kernels; the wrapper picks the route
// (kernels/short_attention.py:short_kv_route).
//
// Replaces: mudg_tpu/kernels/short_attention.py:_short_kv_kernel
// (short_kv_attention, pallas_call at :214).
//
// Bound on this card: bytes. At MDM512 ds1 (32 x 2560 queries, 5 heads, Lk
// = 77) q and o are 105 MB (31 us at 3.35 TB/s) against 8.1 GFLOP (8 us at
// 989 TFLOP/s).
//
// Design: one block of 288 threads per (span of 64-row query tiles, head,
// batch). Warp 8 is the producer: one thread loads the pair's K and V once
// by TMA through the 4-D (64, H, L, B) tensor map (k and v may be strided
// views of one k|v buffer; rows past Lk arrive as zeros), then streams the
// span's q tiles through a ring of SK_STAGES 8 KB stages. Warpgroups 0 and 1
// take alternate q tiles: S = Q K^T by wgmma m64nNKk16 (NK = Lk rounded up
// to 16: 80 at Lk = 77, 16 at Lk = 16) with both operands in shared memory,
// the logits scaled and the keys past Lk masked to -inf in fp32 registers,
// the softmax there, and O = P V by wgmma with P from registers and V read
// through the transpose bit (nothing transposes V). Each warpgroup writes
// its 64 x 64 o tile, swizzled, to its own staging tile and one thread
// stores it by TMA as whole 128-byte rows. Two blocks fit an SM (81 KB of
// shared memory each), so one block's loads overlap the other's products.
#include "hopper.cuh"

namespace mudg {

constexpr int SK_ROWS = 64;          // query rows per tile (one warpgroup)
constexpr int SK_STAGES = 4;         // q tiles in flight per block
constexpr int SK_BOX = 64 * 64 * 2;  // bytes of a 64-row box
constexpr int SK_THREADS = 288;      // two consumer warpgroups + the producer warp
constexpr int SK_BLOCKS_PER_SM = 8;  // blocks wanted per SM in all (two resident at a time)

__host__ __device__ constexpr int sk_kv_boxes(int nk) { return (nk + 63) / 64; }
__host__ __device__ constexpr int sk_smem(int nk) {
  return 1024 + 2 * sk_kv_boxes(nk) * SK_BOX + SK_STAGES * SK_BOX + 2 * SK_BOX + 128;
}

struct ShortKvArgs {
  int lk, span, tiles;  // keys; q tiles per block; q tiles per (batch, head)
  float scale;          // d^-0.5 * log2(e): logits in base 2, scaled in fp32
};

template <int NK>
__global__ void __launch_bounds__(SK_THREADS, NK <= 80 ? 2 : 1)
    short_kv_tma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap to, const ShortKvArgs p) {
  constexpr int KB = sk_kv_boxes(NK);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + KB * SK_BOX;
  uint8_t* sq = sv + KB * SK_BOX;
  uint8_t* staging = sq + SK_STAGES * SK_BOX;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(staging + 2 * SK_BOX);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + SK_STAGES;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * p.span, n = min(p.span, p.tiles - t0);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < SK_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);  // tile i and stage i % 4 belong to warpgroup i % 2
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_kv, 2 * KB * SK_BOX);
      for (int bx = 0; bx < KB; ++bx) {
        tma_load_rows(sk + bx * SK_BOX, &tk, bar_kv, h, 64 * bx, b);
        tma_load_rows(sv + bx * SK_BOX, &tv, bar_kv, h, 64 * bx, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % SK_STAGES;
        if (i >= SK_STAGES) mbar_wait(&empty[s], ((i / SK_STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], SK_BOX);
        tma_load_rows(sq + s * SK_BOX, &tq, &full[s], h, (t0 + i) * SK_ROWS, b);
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  uint8_t* stg = staging + cw * SK_BOX;
  const uint64_t dk = sw128_desc(sk), dv = sw128_desc(sv);
  mbar_wait(bar_kv, 0);
  for (int i = cw; i < n; i += 2) {
    const int s = i % SK_STAGES;
    mbar_wait(&full[s], (i / SK_STAGES) & 1);
    float sc[NK / 2];
    const uint64_t dq = sw128_desc(sq + s * SK_BOX);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<NK>(sc, dq + kk * KMAJOR_K16, dk + kk * KMAJOR_K16, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&empty[s]);

    // softmax over the Lk keys of rows g and g + 8 of this warp's 16
    uint32_t pa[NK / 16][4];
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
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) acc_to_a(pa[kk], sc, kk);

    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) wgmma_rs_n64_tb(o, pa[kk], dv + kk * MNMAJOR_K16);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);   // wgmma reads its register A operand until the wait

    // o -> staging (swizzled) -> one TMA store of the tile's 64 rows
    if (tid == 0) bulk_wait_read<0>();
    named_bar_sync(1 + cw, 128);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * warp + g + 8 * hh;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(stg + sw128_offset(r, 8 * jj + 2 * qd, 64)) =
            pack_bf16x2(o[4 * jj + 2 * hh], o[4 * jj + 2 * hh + 1]);
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);
    if (tid == 0) {
      tma_store_rows(&to, stg, h, (t0 + i) * SK_ROWS, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
}

template <int NK>
static cudaError_t launch_short_kv(const CUtensorMap& tq, const CUtensorMap& tk,
                                   const CUtensorMap& tv, const CUtensorMap& to,
                                   const ShortKvArgs& p, dim3 grid, cudaStream_t s) {
  thread_local bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(short_kv_tma_kernel<NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sk_smem(NK));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  short_kv_tma_kernel<NK><<<grid, SK_THREADS, sk_smem(NK), s>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

}  // namespace mudg

using namespace mudg;

// q (batch, lq, heads, 64), k and v (batch, lk, heads, 64) bf16 with the
// given element strides (the head dim contiguous, every stride a multiple
// of 8, 16-byte aligned pointers); o (batch, lq, heads, 64) bf16
// contiguous. lq % 64 == 0, 1 <= lk <= 128, d == 64 (the signature is
// mudg_short_kv_attn's).
extern "C" int mudg_short_kv_tma(const void* q, const void* k, const void* v, void* o,
                                 int batch, int lq, int lk, int heads, int d,
                                 long long q_sb, long long q_sl, long long q_sh,
                                 long long k_sb, long long k_sl, long long k_sh,
                                 long long v_sb, long long v_sl, long long v_sh,
                                 void* stream) {
  if (lk < 1 || lk > 128 || d != 64 || lq < SK_ROWS || lq % SK_ROWS || batch < 1 || heads < 1)
    return cudaErrorInvalidValue;
  const int sms = mudg_host::sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  using mudg_host::bf16_rows_map;
  CUtensorMap tq, tk, tv, to;
  cudaError_t e = bf16_rows_map(&tq, q, batch, lq, heads, q_sb, q_sl, q_sh);
  if (e == cudaSuccess) e = bf16_rows_map(&tk, k, batch, lk, heads, k_sb, k_sl, k_sh);
  if (e == cudaSuccess) e = bf16_rows_map(&tv, v, batch, lk, heads, v_sb, v_sl, v_sh);
  if (e == cudaSuccess)
    e = bf16_rows_map(&to, o, batch, lq, heads, (long long)lq * heads * 64, heads * 64, 64);
  if (e != cudaSuccess) return e;
  ShortKvArgs p;
  p.lk = lk;
  p.tiles = lq / SK_ROWS;
  // each block takes `span` consecutive q tiles of one (batch, head) pair,
  // about SK_BLOCKS_PER_SM blocks per SM in all: the last wave is a small
  // part of the call, while each block's one K/V load serves several tiles
  const long long pairs = (long long)batch * heads;
  const long long want = (SK_BLOCKS_PER_SM * (long long)sms + pairs - 1) / pairs;
  const int span = p.tiles / want > 1 ? (int)(p.tiles / want) : 1;
  p.span = span;
  p.scale = 0.125f * 1.4426950408889634f;
  const dim3 grid((p.tiles + span - 1) / span, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((lk + 15) / 16) {
    case 1: return launch_short_kv<16>(tq, tk, tv, to, p, grid, s);
    case 2: return launch_short_kv<32>(tq, tk, tv, to, p, grid, s);
    case 3: return launch_short_kv<48>(tq, tk, tv, to, p, grid, s);
    case 4: return launch_short_kv<64>(tq, tk, tv, to, p, grid, s);
    case 5: return launch_short_kv<80>(tq, tk, tv, to, p, grid, s);
    case 6: return launch_short_kv<96>(tq, tk, tv, to, p, grid, s);
    case 7: return launch_short_kv<112>(tq, tk, tv, to, p, grid, s);
    default: return launch_short_kv<128>(tq, tk, tv, to, p, grid, s);
  }
}
