// Kernels 5 and 6 in fp32: flash attention with its logsumexp, and its
// FlashAttention-2 backward, for fp32 q, k, v (B, L, H, 64), head dim 64.
// The functions are those of flash_attn.cu and flash_attn_bwd.cu:
//   o = softmax(q k^T / 8) v,  lse = logsumexp(q k^T / 8)  (natural log),
//   P = exp(q k^T / 8 - lse),  dS = P * (dO v^T - delta),
//   dq = dS k / 8,  dk = dS^T q / 8,  dv = P^T dO.
//
// Replaces: the same Pallas kernels (mudg_tpu/kernels/flash_attention.py,
// pallas_call at :132, :159 forward; :396, :412, :315, :331 backward), which
// take any dtype: an fp32 UNet forward (`sample`'s default dtype, `render
// --dtype f32`) sends its spatial self-attention at L >= 512 to them, and an
// fp32 training step their backward too. Numerics as those kernels in fp32
// (flash_attention.py:53-101, :181-242): q * d^-0.5 * log2(e) in fp32, the
// softmax in base 2, lse = m ln 2 + ln l, every product and sum in fp32.
//
// Bound on this card: FP32 operations. No tensor-core product keeps fp32
// (TF32 rounds the operands to 10 bits), so the products are FMAs at 67
// TFLOP/s: the MDM512 ds1 forward (32 x 2560 x 5 heads) is 268 GFLOP, 4.0 ms.
//
// Design, as kernel 12's fp32 short-KV (short_attn.cu): four threads per
// row, 64 rows per block, each thread holding a quarter of the row's 64
// values as float4 runs (dims 16 i + 4 t .. +3 of thread t); the other
// operand streams through shared memory in chunks of F32_CHUNK rows, and a
// dot product is summed over the four threads by two shuffles.
//   forward: rows are queries; K/V chunks with an online softmax;
//   dq:      rows are queries; K/V chunks; dS per key, dq += dS k;
//   dk/dv:   rows are keys; chunks of the scaled q, q and dO with their lse
//            and delta; dv += P dO, dk += dS q.
// Two backward kernels and no atomics: every gradient element is written
// once, so reruns agree bit for bit.
// Not yet: register tiling over several rows per thread (each key's row is
// read from shared memory once per four FMAs).
#include "common.cuh"

namespace mudg {

constexpr int F32_ROWS = 64;
constexpr int F32_CHUNK = 32;
constexpr float F32_LOG2E = 1.4426950408889634f;

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;   // backward: (B, L, H, 64) contiguous
  const float* lse;    // (B*H, L)
  const float* delta;  // backward: (B*H, L)
  float* o;            // forward output, or dq
  float* lse_out;      // forward
  float* dk;
  float* dv;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  int seq, heads;
  float qscale;  // d^-0.5 * log2(e)
  float scale;   // d^-0.5
};

__device__ __forceinline__ float4 f4_axpy(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

__device__ __forceinline__ float4 f4_scale(float4 x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}

// The dot of this thread's quarter row with row j of a (F32_CHUNK, 64)
// shared tile, summed over the row's four threads.
__device__ __forceinline__ float quad_dot(const float4 (&x)[4], const float* tile, int j, int t) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(tile + j * 64 + i * 16 + 4 * t);
    a = fmaf(x[i].x, y.x, fmaf(x[i].y, y.y, fmaf(x[i].z, y.z, fmaf(x[i].w, y.w, a))));
  }
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  return a + __shfl_xor_sync(0xffffffffu, a, 2);
}

// Rows r0 .. r0 + F32_CHUNK - 1 of a strided (seq, 64) fp32 matrix into a
// (F32_CHUNK, 64) shared tile, times `mul`.
__device__ __forceinline__ void load_chunk(float* tile, const float* base, long long ld, int r0,
                                           float mul) {
  for (int i = threadIdx.x; i < F32_CHUNK * 16; i += blockDim.x) {
    const int r = i >> 4, col = (i & 15) * 4;
    const float4 x = *reinterpret_cast<const float4*>(base + (r0 + r) * ld + col);
    *reinterpret_cast<float4*>(tile + r * 64 + col) = f4_scale(x, mul);
  }
}

__device__ __forceinline__ void load_row(float4 (&x)[4], const float* row, int t, float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = f4_scale(*reinterpret_cast<const float4*>(row + i * 16 + 4 * t), mul);
}

__device__ __forceinline__ void store_row(float* row, const float4 (&x)[4], int t, float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(row + i * 16 + 4 * t) = f4_scale(x[i], mul);
}

__global__ void __launch_bounds__(256) flash_fwd_f32_kernel(const F32Args p) {
  __shared__ __align__(16) float ks[F32_CHUNK * 64];
  __shared__ __align__(16) float vs[F32_CHUNK * 64];
  const int t = threadIdx.x & 3, qi = blockIdx.x * F32_ROWS + (threadIdx.x >> 2);
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  float4 qv[4], o[4];
  load_row(qv, p.q + b * p.q_sb + qi * p.q_sl + h * p.q_sh, t, p.qscale);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < p.seq; k0 += F32_CHUNK) {
    __syncthreads();  // every thread is done with the previous chunk
    load_chunk(ks, kb, p.k_sl, k0, 1.f);
    load_chunk(vs, vb, p.v_sl, k0, 1.f);
    __syncthreads();
    float s[F32_CHUNK], mx = m;
#pragma unroll
    for (int j = 0; j < F32_CHUNK; ++j) {
      s[j] = quad_dot(qv, ks, j, t);
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(m - mx);  // 0 on the first chunk
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = f4_scale(o[i], alpha);
#pragma unroll
    for (int j = 0; j < F32_CHUNK; ++j) {
      const float pj = exp2f(s[j] - m);
      l += pj;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = f4_axpy(pj, *reinterpret_cast<const float4*>(vs + j * 64 + i * 16 + 4 * t), o[i]);
    }
  }
  store_row(p.o + (((size_t)b * p.seq + qi) * p.heads + h) * 64, o, t, 1.f / l);
  if (t == 0)
    p.lse_out[((size_t)b * p.heads + h) * p.seq + qi] = m * 0.6931471805599453f + logf(l);
}

__global__ void __launch_bounds__(256) flash_bwd_dq_f32_kernel(const F32Args p) {
  __shared__ __align__(16) float ks[F32_CHUNK * 64];
  __shared__ __align__(16) float vs[F32_CHUNK * 64];
  const int t = threadIdx.x & 3, qi = blockIdx.x * F32_ROWS + (threadIdx.x >> 2);
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const size_t orow = (((size_t)b * p.seq + qi) * p.heads + h) * 64;
  const size_t srow = ((size_t)b * p.heads + h) * p.seq + qi;
  float4 qv[4], dov[4], dq[4];
  load_row(qv, p.q + b * p.q_sb + qi * p.q_sl + h * p.q_sh, t, p.qscale);
  load_row(dov, p.dout + orow, t, 1.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) dq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse2 = p.lse[srow] * F32_LOG2E, dl = p.delta[srow];
  for (int k0 = 0; k0 < p.seq; k0 += F32_CHUNK) {
    __syncthreads();
    load_chunk(ks, kb, p.k_sl, k0, 1.f);
    load_chunk(vs, vb, p.v_sl, k0, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < F32_CHUNK; ++j) {
      const float pj = exp2f(quad_dot(qv, ks, j, t) - lse2);
      const float ds = pj * (quad_dot(dov, vs, j, t) - dl);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dq[i] = f4_axpy(ds, *reinterpret_cast<const float4*>(ks + j * 64 + i * 16 + 4 * t), dq[i]);
    }
  }
  store_row(p.o + orow, dq, t, p.scale);
}

__global__ void __launch_bounds__(256) flash_bwd_dkv_f32_kernel(const F32Args p) {
  __shared__ __align__(16) float qss[F32_CHUNK * 64];  // q * qscale
  __shared__ __align__(16) float qs[F32_CHUNK * 64];
  __shared__ __align__(16) float dos[F32_CHUNK * 64];
  __shared__ float lse_s[F32_CHUNK], dl_s[F32_CHUNK];
  const int t = threadIdx.x & 3, ki = blockIdx.x * F32_ROWS + (threadIdx.x >> 2);
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* dob = p.dout + ((size_t)b * p.seq * p.heads + h) * 64;
  const size_t sbase = ((size_t)b * p.heads + h) * p.seq;
  float4 kv[4], vv[4], dk[4], dv[4];
  load_row(kv, p.k + b * p.k_sb + ki * p.k_sl + h * p.k_sh, t, 1.f);
  load_row(vv, p.v + b * p.v_sb + ki * p.v_sl + h * p.v_sh, t, 1.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) dk[i] = dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q0 = 0; q0 < p.seq; q0 += F32_CHUNK) {
    __syncthreads();
    load_chunk(qss, qb, p.q_sl, q0, p.qscale);
    load_chunk(qs, qb, p.q_sl, q0, 1.f);
    load_chunk(dos, dob, (long long)p.heads * 64, q0, 1.f);
    if (threadIdx.x < F32_CHUNK) {
      lse_s[threadIdx.x] = p.lse[sbase + q0 + threadIdx.x] * F32_LOG2E;
      dl_s[threadIdx.x] = p.delta[sbase + q0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < F32_CHUNK; ++j) {
      const float pj = exp2f(quad_dot(kv, qss, j, t) - lse_s[j]);
      const float ds = pj * (quad_dot(vv, dos, j, t) - dl_s[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dv[i] = f4_axpy(pj, *reinterpret_cast<const float4*>(dos + j * 64 + i * 16 + 4 * t), dv[i]);
        dk[i] = f4_axpy(ds, *reinterpret_cast<const float4*>(qs + j * 64 + i * 16 + 4 * t), dk[i]);
      }
    }
  }
  const size_t orow = (((size_t)b * p.seq + ki) * p.heads + h) * 64;
  store_row(p.dk + orow, dk, t, p.scale);
  store_row(p.dv + orow, dv, t, 1.f);
}

static F32Args f32_args(const void* q, const void* k, const void* v, int seq, int heads,
                        const long long (&st)[9]) {
  F32Args p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.q_sb = st[0]; p.q_sl = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_sl = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_sl = st[7]; p.v_sh = st[8];
  p.seq = seq;
  p.heads = heads;
  p.scale = 0.125f;
  p.qscale = 0.125f * F32_LOG2E;
  return p;
}

}  // namespace mudg

using namespace mudg;

// q, k, v: (batch, seq, heads, 64) fp32 with the given element strides (head
// dim contiguous, every stride a multiple of 4, 16-byte aligned pointers);
// o: (batch, seq, heads, 64) fp32 contiguous; lse: (batch*heads, seq) fp32.
// seq % 64 == 0.
extern "C" int mudg_flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int batch, int seq, int heads,
                                   long long q_sb, long long q_sl, long long q_sh,
                                   long long k_sb, long long k_sl, long long k_sh,
                                   long long v_sb, long long v_sl, long long v_sh,
                                   void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  F32Args p = f32_args(q, k, v, seq, heads, st);
  p.o = static_cast<float*>(o);
  p.lse_out = static_cast<float*>(lse);
  flash_fwd_f32_kernel<<<dim3(seq / F32_ROWS, heads, batch), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// As mudg_flash_attn_bwd in fp32 (dout, dq, dk, dv contiguous).
extern "C" int mudg_flash_attn_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, void* dk, void* dv, int batch, int seq,
                                       int heads, long long q_sb, long long q_sl, long long q_sh,
                                       long long k_sb, long long k_sl, long long k_sh,
                                       long long v_sb, long long v_sl, long long v_sh,
                                       void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  F32Args p = f32_args(q, k, v, seq, heads, st);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.o = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(seq / F32_ROWS, heads, batch);
  flash_bwd_dq_f32_kernel<<<grid, 256, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_f32_kernel<<<grid, 256, 0, s>>>(p);
  return cudaGetLastError();
}
