// Kernel 2: one stage of the temporal transformer's double self-attention,
//   out = x + (softmax_T(LN(x) Wq (LN(x) Wk)^T / sqrt(d)) LN(x) Wv) Wo + bo,
// over tokens (N*T, C) where each sequence is T = 16 consecutive rows. The
// wrapper runs it twice, stage 1 then stage 2, for one dispatch site.
//
// Replaces: mudg_tpu/kernels/temporal_attn.py:_kernel (both stages, pallas_call
// at :205) and :_kernel1 (one stage per call, :226), public op
// fused_double_self_attn. Numerics as its _attn_stage (:54-96): LN with fp32
// statistics rounded to bf16; q, k and v rounded to bf16 after their fp32
// products, Wq carrying d^-0.5 * log2(e); the softmax normalised before P V;
// o rounded to bf16 per head; x + o Wo + bo.
//
// Bound on this card: bytes. Each token attends to only 16 others, so the
// attention core is 2*2*16*64 FLOP per token and head, far below the card's
// ~295 FLOP/byte balance; the projections are short-K GEMMs (K = C).
//
// Offsets: rows reach 1.33e6 at ds1 of a 3-task, 3-variant MDM1024 batch
// (x 320 columns: 4.2e8 elements); every element offset is formed in size_t (the
// LayerNorm rows) or held by TMA as per-dimension int32 coordinates (the
// GEMMs' rows and columns).
//
// Design: three launches a stage on the port's Hopper machinery:
//   1. xn = LN(x) in bf16 by kernel 11's LayerNorm body (TMA cannot
//      normalise on its way into shared memory);
//   2. o = attention(xn Wqkv'^T) on the persistent TMA + wgmma GEMM with the
//      attention as its epilogue (wgmma_gemm.cuh's WG_TATTN): a tile is 64
//      rows, four whole sequences since a tile starts at a multiple of 64,
//      by the 192 rows of one head of the head-ordered packing [q_h | k_h |
//      v_h]. The wgmma accumulator rows of warp w are rows 16 w .. 16 w + 15
//      of the tile, exactly one sequence, so each warp takes q, k and v of
//      its sequence from its own registers (q and k are mma.sync fragments
//      as they lie, v is transposed by movmatrix) and runs the 16 x 16
//      block-diagonal attention there: the TPU kernel masks a 128 x 128
//      logits tile to its 16 x 16 diagonal blocks for its matrix unit,
//      here nothing is masked. q|k|v never reaches device memory; only o_h
//      (64 x 64) leaves, by TMA, at column 64 h of o.
//   3. out = o Wo^T + bo + x on the same GEMM (WG_BIAS_RES), the residual
//      read by TMA.
// A stage moves 7 (rows, C) bf16 tensors through device memory: LN 2, step
// 2 1 + 1 (xn is read once per head, from L2 for the heads after the
// first), step 3 3. o needs a buffer of its own: xn is read by the tiles of
// every head while o's columns are written.
#include "wgmma_gemm.cuh"

using namespace mudg;

extern "C" int mudg_layer_norm(const void* x, void* y, const void* w, const void* b, int rows,
                               int c, int fp32, float eps, void* stream);

// One stage. x, out: (rows, c) bf16 with rows % 64 == 0 and sequences of 16
// consecutive rows, c % 64 == 0. Scratch: xn and o (rows, c) bf16. Weights:
// ln_w, ln_b, bo fp32 (c); wqkv (3c, c) bf16 in head order, rows 192 h ..
// 192 h + 191 = [Wq'_h | Wk_h | Wv_h] with the softmax scale folded into
// Wq'; wo (c, c) bf16.
extern "C" int mudg_temporal_attn_stage(const void* x, void* out, void* xn, void* o,
                                        const void* ln_w, const void* ln_b, const void* wqkv,
                                        const void* wo, const void* bo, int rows, int c,
                                        void* stream) {
  if (rows % 64 || c % 64) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      static_cast<cudaError_t>(mudg_layer_norm(x, xn, ln_w, ln_b, rows, c, 0, 1e-5f, stream));
  if (err != cudaSuccess) return err;
  bf16* ob = static_cast<bf16*>(o);
  err = launch_wgmma_tattn(static_cast<const bf16*>(xn), static_cast<const bf16*>(wqkv), ob,
                           rows, c, st);
  if (err != cudaSuccess) return err;
  return launch_wgmma_gemm<WG_BIAS_RES>(ob, c, static_cast<const bf16*>(wo), c,
                                        static_cast<bf16*>(out), c, static_cast<const bf16*>(x),
                                        c, static_cast<const float*>(bo), rows, c, c, 0, st);
}
