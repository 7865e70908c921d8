// Kernel 12: attention over short sequences, non-causal, no bias, fp32
// softmax, P rounded to bf16 for the P @ V product, head dim D = 64 or 128:
//   short-KV: o = softmax(q k^T / sqrt(D)) v, q (B, Lq, H, D) over a small
//             K/V (B, Lk, H, D), Lk <= 1024 (the UNet's text and image
//             cross-attention: Lk = 77 and 16);
//   packed:   the same self-attention over each (b, h) sequence of q, k, v
//             (B, T, H, D) on its own, T <= 64 and 128 % T == 0 (the
//             temporal-attention shape, T = 16).
//
// Replaces: mudg_tpu/kernels/short_attention.py:_short_kv_kernel
// (short_kv_attention, pallas_call at :214) and _packed_kernel
// (packed_short_attention, :81).
//
// Bound on this card: bytes at MuDG's shapes. A short-KV call at MDM512 ds1
// (32 x 2560 queries, 5 heads, Lk = 77) does 4 * 409,600 * 77 * 64 = 8.1
// GFLOP (8 us at 989 TFLOP/s) against 105 MB of q and o (31 us at 3.35
// TB/s); the packed call at T = 16 does 16 x fewer operations per byte.
//
// Design. The TPU folds q/k/v to (B*H, L, D) and pads K/V to 128 lanes
// (short-KV), or packs 128 // T sequences into one 128-row block-diagonal
// product (packed); both exist to feed a 128 x 128 MXU and cost copies and a
// G-fold overcompute. Neither is done here. Both kernels read q, k and v in
// place through their (batch, sequence, head) strides, stage tiles of 64
// rows in shared memory and multiply with mma.sync m16n8k16 (bf16 in, fp32
// accumulate), 4 warps of 16 query rows per block:
//   short-KV: (bf16 at head dim 64 and Lk <= 128, every MuDG site, runs on
//             short_kv.cu's TMA + wgmma kernel instead; this one takes the
//             rest the predicate admits: Lk up to 1024, head dim 128)
//             one block per (64 queries, head, batch); K/V stream through
//             shared memory in 64-key chunks (V transposed) with an online
//             softmax across chunks, so every Lk <= 1024 and D = 128 fit in
//             36 KB; keys past Lk are zero-filled and their logits masked to
//             -inf (the TPU kernel's padded columns, :171-173);
//   packed:   one block per 64 consecutive rows of the (B*H, T) sequence
//             order, i.e. 64 / T whole sequences; each warp attends its 16
//             rows to their own sequence's keys only (T >= 16), or to the
//             16 rows of its tile with the other sequences' keys masked
//             (T < 16, the least an m16n8k16 tile can take), and normalises
//             P before rounding it, as _packed_kernel does.
// fp32 short-KV: FMA products, below, for head dim 128 or Lk > 128 (every
// MuDG fp32 site, head dim 64 and Lk <= 128, runs on short_kv_f32.cu).
// Not yet: cp.async double-buffering of the K/V chunks, wgmma.
#include "common.cuh"

namespace mudg {

constexpr int SA_ROWS = 64;           // rows of a staged tile
constexpr int SA_LDT = SA_ROWS + 8;   // padded row of the transposed V tile

struct StridedRows {  // row r at base + r * stride
  const bf16* base;
  long long stride;
  __device__ const bf16* operator()(int r) const { return base + r * stride; }
};

// Row r of a block's 64 consecutive rows of the (B*H, T) sequence order of a
// (B, T, H, D) tensor.
template <int T>
struct PackedRows {
  const bf16* base;
  long long sb, sl, sh;
  int heads, r0;
  __device__ const bf16* operator()(int r) const {
    const int s = (r0 + r) / T, t = (r0 + r) % T;
    return base + (s / heads) * sb + t * sl + (s % heads) * sh;
  }
};

// Copy rows 0 .. nvalid-1 of a 64 x D tile (zeros below) into shared memory,
// row-major (row stride D + 8) or transposed (row stride SA_LDT).
template <int D, bool TRANSPOSE, class Rows>
__device__ __forceinline__ void load_rows(bf16* dst, const Rows& rows, int nvalid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < SA_ROWS * CPR; i += blockDim.x) {
    const int r = i / CPR, col = (i % CPR) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) v = *reinterpret_cast<const uint4*>(rows(r) + col);
    if (TRANSPOSE) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(col + j) * SA_LDT + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * (D + 8) + col) = v;
    }
  }
}

// A fragments of this warp's 16 rows over the D columns of a row-major tile.
template <int D>
__device__ __forceinline__ void q_frags(uint32_t qf[D / 16][4], const bf16* qs, int warp,
                                        int g, int q) {
  const int r = warp * 16 + g;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* p = qs + ks * 16 + 2 * q;
    qf[ks][0] = lds32(p + r * (D + 8));
    qf[ks][1] = lds32(p + (r + 8) * (D + 8));
    qf[ks][2] = lds32(p + r * (D + 8) + 8);
    qf[ks][3] = lds32(p + (r + 8) * (D + 8) + 8);
  }
}

// s[nj] = Q(16 x D) @ K^T over the key rows key0 + 8 nj .. of a row-major tile.
template <int D, int NF>
__device__ __forceinline__ void logits(float s[NF][4], const uint32_t qf[D / 16][4],
                                       const bf16* ks, int key0, int g, int q) {
#pragma unroll
  for (int nj = 0; nj < NF; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nj][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nj = 0; nj < NF; ++nj) {
      const bf16* kr = ks + (key0 + nj * 8 + g) * (D + 8) + kk * 16 + 2 * q;
      const uint32_t b[2] = {lds32(kr), lds32(kr + 8)};
      mma_16816(s[nj], qf[kk], b);
    }
  }
}

// o[dj] += P(16 x 16 KK) @ V over keys key0 .. of the transposed V tile; P
// comes from the logits' accumulator fragments, rounded to bf16.
template <int D, int KK>
__device__ __forceinline__ void pv(float o[D / 8][4], const float s[2 * KK][4],
                                   const bf16* vt, int key0, int g, int q) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dj = 0; dj < D / 8; ++dj) {
      const bf16* vr = vt + (dj * 8 + g) * SA_LDT + key0 + kk * 16 + 2 * q;
      const uint32_t b[2] = {lds32(vr), lds32(vr + 8)};
      mma_16816(o[dj], a, b);
    }
  }
}

__device__ __forceinline__ float quad_max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store this warp's 16 rows of o, each scaled by scale[row half], to the
// rows of a (.., D) output given by `rows`.
template <int D, class Rows>
__device__ __forceinline__ void store_rows(const Rows& rows, int warp,
                                           const float o[D / 8][4], const float scale[2],
                                           int g, int q) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    bf16* orow = const_cast<bf16*>(rows(warp * 16 + g + 8 * hh));
#pragma unroll
    for (int dj = 0; dj < D / 8; ++dj)
      *reinterpret_cast<uint32_t*>(orow + dj * 8 + 2 * q) =
          pack_bf16x2(o[dj][2 * hh] * scale[hh], o[dj][2 * hh + 1] * scale[hh]);
  }
}

template <class T>
struct ShortArgsT {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  long long q_sb, q_sl, q_sh;  // element strides over batch, sequence, head
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  int lq, lk, heads;
  float scale;  // d^-0.5 * log2(e): logits in base 2, scaled in fp32
};
typedef ShortArgsT<bf16> ShortArgs;

template <int D>
__global__ void __launch_bounds__(128) short_kv_kernel(const ShortArgs p) {
  __shared__ __align__(16) bf16 ks[SA_ROWS * (D + 8)];  // the q tile, then each K chunk
  __shared__ __align__(16) bf16 vt[D * SA_LDT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int q0 = blockIdx.x * SA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;

  load_rows<D, false>(ks, StridedRows{p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_sl, p.q_sl},
                      SA_ROWS);
  __syncthreads();
  uint32_t qf[D / 16][4];
  q_frags<D>(qf, ks, warp, g, q);

  float o[D / 8][4];
#pragma unroll
  for (int dj = 0; dj < D / 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dj][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < p.lk; k0 += SA_ROWS) {
    const int nvalid = min(SA_ROWS, p.lk - k0);
    __syncthreads();  // every warp is done with the previous tile
    load_rows<D, false>(ks, StridedRows{kb + k0 * p.k_sl, p.k_sl}, nvalid);
    load_rows<D, true>(vt, StridedRows{vb + k0 * p.v_sl, p.v_sl}, nvalid);
    __syncthreads();
    float s[8][4];
    logits<D, 8>(s, qf, ks, 0, g, q);
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nj][e] = nj * 8 + 2 * q + (e & 1) < nvalid ? s[nj][e] * p.scale : -INFINITY;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
        mx = fmaxf(mx, fmaxf(s[nj][2 * hh], s[nj][2 * hh + 1]));
      const float mnew = fmaxf(m[hh], quad_max4(mx));
      const float alpha = exp2f(m[hh] - mnew);
      m[hh] = mnew;
      l[hh] *= alpha;
#pragma unroll
      for (int dj = 0; dj < D / 8; ++dj) {
        o[dj][2 * hh] *= alpha;
        o[dj][2 * hh + 1] *= alpha;
      }
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        s[nj][2 * hh] = exp2f(s[nj][2 * hh] - mnew);
        s[nj][2 * hh + 1] = exp2f(s[nj][2 * hh + 1] - mnew);
        l[hh] += s[nj][2 * hh] + s[nj][2 * hh + 1];
      }
    }
    pv<D, 4>(o, s, vt, 0, g, q);
  }
  const float inv[2] = {1.f / quad_sum4(l[0]), 1.f / quad_sum4(l[1])};
  const long long o_sl = (long long)p.heads * D;
  store_rows<D>(StridedRows{p.o + ((size_t)b * p.lq + q0) * o_sl + h * D, o_sl}, warp, o, inv,
                g, q);
}

template <int D, int T>
__global__ void __launch_bounds__(128) packed_kernel(const ShortArgs p) {
  __shared__ __align__(16) bf16 ks[SA_ROWS * (D + 8)];  // the q tile, then the K tile
  __shared__ __align__(16) bf16 vt[D * SA_LDT];
  constexpr int NK = T >= 16 ? T : 16;  // keys a warp's rows attend (one tile at least)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = blockIdx.x * SA_ROWS;

  load_rows<D, false>(ks, PackedRows<T>{p.q, p.q_sb, p.q_sl, p.q_sh, p.heads, r0}, SA_ROWS);
  __syncthreads();
  uint32_t qf[D / 16][4];
  q_frags<D>(qf, ks, warp, g, q);
  __syncthreads();
  load_rows<D, false>(ks, PackedRows<T>{p.k, p.k_sb, p.k_sl, p.k_sh, p.heads, r0}, SA_ROWS);
  load_rows<D, true>(vt, PackedRows<T>{p.v, p.v_sb, p.v_sl, p.v_sh, p.heads, r0}, SA_ROWS);
  __syncthreads();

  // first key row of this warp's sequence (T >= 16) or 16-row tile (T < 16)
  const int key0 = T >= 16 ? (warp * 16 / T) * T : warp * 16;
  float s[NK / 8][4];
  logits<D, NK / 8>(s, qf, ks, key0, g, q);
#pragma unroll
  for (int nj = 0; nj < NK / 8; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), col = nj * 8 + 2 * q + (e & 1);
      s[nj][e] = (T >= 16 || row / T == col / T) ? s[nj][e] * p.scale : -INFINITY;
    }
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int nj = 0; nj < NK / 8; ++nj)
      mx = fmaxf(mx, fmaxf(s[nj][2 * hh], s[nj][2 * hh + 1]));
    mx = quad_max4(mx);
    float sum = 0.f;
#pragma unroll
    for (int nj = 0; nj < NK / 8; ++nj) {
      s[nj][2 * hh] = exp2f(s[nj][2 * hh] - mx);
      s[nj][2 * hh + 1] = exp2f(s[nj][2 * hh + 1] - mx);
      sum += s[nj][2 * hh] + s[nj][2 * hh + 1];
    }
    inv[hh] = 1.f / quad_sum4(sum);
#pragma unroll
    for (int nj = 0; nj < NK / 8; ++nj) {  // P normalised before its bf16 rounding
      s[nj][2 * hh] *= inv[hh];
      s[nj][2 * hh + 1] *= inv[hh];
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int dj = 0; dj < D / 8; ++dj)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dj][e] = 0.f;
  pv<D, NK / 16>(o, s, vt, key0, g, q);
  const float one[2] = {1.f, 1.f};
  const long long o_sl = (long long)p.heads * D;
  store_rows<D>(PackedRows<T>{p.o, T * o_sl, o_sl, D, p.heads, r0}, warp, o, one, g, q);
}

// fp32 short-KV beyond short_kv_f32.cu's shapes (head dim 128 or Lk > 128;
// no MuDG site): the same function with fp32 operands on FMAs: four
// threads per query row, 64 rows per block, each thread holding a quarter
// of q and o as float4 runs (dims 16 i + 4 t .. +3 of thread t), the logit
// of a key summed over the four by two shuffles; K/V stream through shared
// memory in chunks of SF_KEYS keys with an online softmax, as above.
constexpr int SF_KEYS = 32;

__device__ __forceinline__ float4 f4_fma(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

template <int D>
__global__ void __launch_bounds__(256) short_kv_f32_kernel(const ShortArgsT<float> p) {
  __shared__ __align__(16) float ks[SF_KEYS * D];
  __shared__ __align__(16) float vs[SF_KEYS * D];
  constexpr int NV = D / 16;  // float4 runs per thread
  const int t = threadIdx.x & 3, qi = blockIdx.x * SA_ROWS + (threadIdx.x >> 2);
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qr = p.q + b * p.q_sb + qi * p.q_sl + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  float4 qv[NV], o[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(qr + i * 16 + 4 * t);
    qv[i] = make_float4(x.x * p.scale, x.y * p.scale, x.z * p.scale, x.w * p.scale);
    o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < p.lk; k0 += SF_KEYS) {
    const int nvalid = min(SF_KEYS, p.lk - k0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < SF_KEYS * D / 4; i += blockDim.x) {
      const int r = i / (D / 4), col = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (r < nvalid) {
        kv = *reinterpret_cast<const float4*>(kb + (k0 + r) * p.k_sl + col);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + r) * p.v_sl + col);
      }
      *reinterpret_cast<float4*>(ks + r * D + col) = kv;
      *reinterpret_cast<float4*>(vs + r * D + col) = vv;
    }
    __syncthreads();
    float s[SF_KEYS], mx = m;
#pragma unroll
    for (int j = 0; j < SF_KEYS; ++j) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + j * D + i * 16 + 4 * t);
        a = fmaf(qv[i].x, kk.x, fmaf(qv[i].y, kk.y, fmaf(qv[i].z, kk.z, fmaf(qv[i].w, kk.w, a))));
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      s[j] = j < nvalid ? a : -INFINITY;  // keys past Lk masked
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(m - mx);  // 0 on the first chunk
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      o[i] = make_float4(o[i].x * alpha, o[i].y * alpha, o[i].z * alpha, o[i].w * alpha);
#pragma unroll
    for (int j = 0; j < SF_KEYS; ++j) {
      const float pj = exp2f(s[j] - m);
      l += pj;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        o[i] = f4_fma(pj, *reinterpret_cast<const float4*>(vs + j * D + i * 16 + 4 * t), o[i]);
    }
  }
  const float inv = 1.f / l;
  float* orow = p.o + (((size_t)b * p.lq + qi) * p.heads + h) * D;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    *reinterpret_cast<float4*>(orow + i * 16 + 4 * t) =
        make_float4(o[i].x * inv, o[i].y * inv, o[i].z * inv, o[i].w * inv);
}

template <class T>
static ShortArgsT<T> short_args(const void* q, const void* k, const void* v, void* o, int heads,
                                int d, const long long* st) {
  ShortArgsT<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<T*>(o);
  p.q_sb = st[0]; p.q_sl = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_sl = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_sl = st[7]; p.v_sh = st[8];
  p.heads = heads;
  p.scale = 1.4426950408889634f / sqrtf((float)d);
  return p;
}

template <int D>
static cudaError_t launch_packed(const ShortArgs& p, int blocks, int t, cudaStream_t s) {
  switch (t) {
    case 1: packed_kernel<D, 1><<<blocks, 128, 0, s>>>(p); break;
    case 2: packed_kernel<D, 2><<<blocks, 128, 0, s>>>(p); break;
    case 4: packed_kernel<D, 4><<<blocks, 128, 0, s>>>(p); break;
    case 8: packed_kernel<D, 8><<<blocks, 128, 0, s>>>(p); break;
    case 16: packed_kernel<D, 16><<<blocks, 128, 0, s>>>(p); break;
    case 32: packed_kernel<D, 32><<<blocks, 128, 0, s>>>(p); break;
    case 64: packed_kernel<D, 64><<<blocks, 128, 0, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mudg

using namespace mudg;

// q (batch, lq, heads, d), k and v (batch, lk, heads, d) bf16 with the given
// element strides (the head dim contiguous, every stride a multiple of 8,
// 16-byte aligned pointers); o (batch, lq, heads, d) bf16 contiguous.
// d = 64 or 128, lq % 64 == 0, 1 <= lk.
extern "C" int mudg_short_kv_attn(const void* q, const void* k, const void* v, void* o,
                                  int batch, int lq, int lk, int heads, int d,
                                  long long q_sb, long long q_sl, long long q_sh,
                                  long long k_sb, long long k_sl, long long k_sh,
                                  long long v_sb, long long v_sl, long long v_sh,
                                  void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  ShortArgs p = short_args<bf16>(q, k, v, o, heads, d, st);
  p.lq = lq;
  p.lk = lk;
  const dim3 grid(lq / SA_ROWS, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) short_kv_kernel<64><<<grid, 128, 0, s>>>(p);
  else if (d == 128) short_kv_kernel<128><<<grid, 128, 0, s>>>(p);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// As mudg_short_kv_attn with fp32 q, k, v and o (strides a multiple of 4
// elements, 16-byte aligned pointers).
extern "C" int mudg_short_kv_attn_f32(const void* q, const void* k, const void* v, void* o,
                                      int batch, int lq, int lk, int heads, int d,
                                      long long q_sb, long long q_sl, long long q_sh,
                                      long long k_sb, long long k_sl, long long k_sh,
                                      long long v_sb, long long v_sl, long long v_sh,
                                      void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  ShortArgsT<float> p = short_args<float>(q, k, v, o, heads, d, st);
  p.lq = lq;
  p.lk = lk;
  const dim3 grid(lq / SA_ROWS, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) short_kv_f32_kernel<64><<<grid, 256, 0, s>>>(p);
  else if (d == 128) short_kv_f32_kernel<128><<<grid, 256, 0, s>>>(p);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// q, k, v (batch, t, heads, d) bf16 with strides as above; o (batch, t, heads,
// d) bf16 contiguous. d = 64 or 128, t in {1, 2, 4, .., 64},
// (batch * heads * t) % 64 == 0.
extern "C" int mudg_packed_attn(const void* q, const void* k, const void* v, void* o,
                                int batch, int t, int heads, int d,
                                long long q_sb, long long q_sl, long long q_sh,
                                long long k_sb, long long k_sl, long long k_sh,
                                long long v_sb, long long v_sl, long long v_sh,
                                void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  const ShortArgs p = short_args<bf16>(q, k, v, o, heads, d, st);
  const int blocks = batch * heads * t / SA_ROWS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_packed<64>(p, blocks, t, s);
  if (d == 128) return launch_packed<128>(p, blocks, t, s);
  return cudaErrorInvalidValue;
}
