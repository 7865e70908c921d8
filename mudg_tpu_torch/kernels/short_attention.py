"""Kernel 12: attention over short sequences (CUDA, `csrc/short_kv.cu` and
`csrc/short_attn.cu`).

`short_kv_attention`: q (B, Lq, H, D) over a small K/V (B, Lk, H, D),
Lk <= 1024 (the UNet's text and image cross-attention).
`packed_short_attention`: self-attention over each (b, h) sequence of q, k,
v (B, T, H, D), T <= 64 (the temporal-attention shape). Both non-causal, fp32 softmax,
probabilities cast to v's dtype for the P @ V product. Replace
`mudg_tpu/kernels/short_attention.py`'s `_short_kv_kernel` (pallas_call at
:214) and `_packed_kernel` (:81); the design notes are at the top of the .cu
files. `short_kv_route` picks the short-KV kernel: at every MuDG site K/V
are held whole in shared memory, `csrc/short_kv.cu` in bf16 and
`csrc/short_kv_f32.cu` (3xTF32 wgmma) in fp32; `csrc/short_attn.cu`'s
streaming kernels take the rest of what the predicate admits.

`attend` takes `short_kv_attention` where the JAX dispatch takes its Pallas
kernel: under `MUDG_SHORT_ATTN=1`, impl "auto" or "train", where the copied
predicate `short_kv_attention_eligible` holds (attention.py:100-113). No
model path of the JAX package calls `packed_short_attention`; its public
function is its path.

The wrappers run the plain version for a CPU (or meta) tensor and launch the
kernel for a CUDA tensor, or raise: head dim 64 or 128; short-KV takes bf16
or fp32, as the Pallas kernel takes either (an fp32 `sample` reaches it
under the switch), packed bf16 only (no path feeds it fp32).
`short_kv_attention_op` / `packed_short_attention_op` are the ops with a
gradient, whose backward is `_packed_vjp_bwd` (:141-152) in plain torch,
with the probabilities recomputed.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..nn import remat as R

launches = 0          # short-KV kernel launches
packed_launches = 0   # packed kernel launches


def packed_short_attention_eligible(q) -> bool:
    """`mudg_tpu/kernels/short_attention.py:packed_short_attention_eligible`."""
    b, t, h, d = q.shape
    return t <= 64 and 128 % t == 0 and d in (64, 128) and (b * h * t) % 128 == 0


def short_kv_attention_eligible(q, k) -> bool:
    """`mudg_tpu/kernels/short_attention.py:short_kv_attention_eligible`."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    return lk <= 1024 and d in (64, 128) and lq % 256 == 0


SKV_TMA_MAX_KEYS = 128   # csrc/short_kv.cu and short_kv_f32.cu hold K and V whole up to this


def short_kv_route(dtype, d: int, lk: int) -> str:
    """Which kernel a short-KV call launches at head dim 64 and Lk <= 128
    (every MuDG site): "tma" in bf16 (`csrc/short_kv.cu`: K/V loaded once per
    block by TMA, held whole in shared memory), "tf32" in fp32
    (`csrc/short_kv_f32.cu`: the same layout, K and V^T split once per pair
    into tf32 hi and lo copies, every product three tf32 wgmma products);
    else "stream" (`csrc/short_attn.cu`: K/V streamed in chunks with an
    online softmax, mma.sync in bf16 and FMAs in fp32; the rest the
    predicate admits, Lk up to 1024 and head dim 128)."""
    if d == 64 and 1 <= lk <= SKV_TMA_MAX_KEYS:
        if dtype == torch.bfloat16:
            return "tma"
        if dtype == torch.float32:
            return "tf32"
    return "stream"


def plain_short_attention(q, k, v):
    """Both kernels' plain version, `nn/attention.plain_attend`: dense
    attention of q (B, Lq, H, D) over k, v (B, Lk, H, D), logits and softmax
    in fp32, probabilities cast to v's dtype for P @ V (`_dense_math`,
    short_attention.py:129-134); for packed, Lq = Lk = T and each (b, h)
    sequence attends its own keys."""
    from ..nn.attention import plain_attend
    return plain_attend(q, k, v)


def plain_attention_bwd(q, k, v, g):
    """`_packed_vjp_bwd` (short_attention.py:141-152): (dq, dk, dv) of the
    dense attention for the upstream g, probabilities recomputed."""
    from ..nn.attention import dense_logits
    scale = q.shape[-1] ** -0.5
    p = torch.softmax(dense_logits(q, k), dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype), g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype), k)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype), q)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operands(name, dtypes, *ts):
    for t, what in zip(ts, "qkv"):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device}")
        if t.dtype not in dtypes or t.dtype != ts[0].dtype:
            raise ValueError(f"{name}: {what} must be one of {dtypes} as q is, got {t.dtype}")
        if t.ndim != 4 or t.shape[-1] not in (64, 128):
            raise ValueError(f"{name}: {what} must be (B, L, H, 64 or 128), got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name}: {what}'s head dim must be contiguous and every "
                             f"stride a multiple of 8, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what}'s data pointer is not 16-byte aligned")


def _strides(*ts):
    return [ctypes.c_longlong(s) for t in ts for s in t.stride()[:3]]


def short_kv_attention(q, k, v):
    """Attention of q (B, Lq, H, D) over k, v (B, Lk, H, D) -> (B, Lq, H, D)."""
    global launches
    if q.device.type in ("cpu", "meta"):
        return plain_short_attention(q, k, v)
    _check_operands("short_kv_attention", (torch.bfloat16, torch.float32), q, k, v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d) or lk < 1
            or not short_kv_attention_eligible(q, k)):
        raise ValueError(f"short_kv_attention: unsupported shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    o = torch.empty(b, lq, h, d, device=q.device, dtype=q.dtype)
    lib = _build.load()
    P = _build.ptr
    fn = {"tma": lib.mudg_short_kv_tma, "tf32": lib.mudg_short_kv_tf32,
          "stream": lib.mudg_short_kv_attn_f32 if q.dtype == torch.float32
          else lib.mudg_short_kv_attn}[short_kv_route(q.dtype, d, lk)]
    err = fn(P(q), P(k), P(v), P(o), b, lq, lk, h, d, *_strides(q, k, v), _build.stream())
    _build.check(err, "short_kv_attention")
    launches += 1
    return o


def packed_short_attention(q, k, v):
    """Self-attention over each (b, h) sequence of q, k, v (B, T, H, D)."""
    global packed_launches
    if q.device.type in ("cpu", "meta"):
        return plain_short_attention(q, k, v)
    _check_operands("packed_short_attention", (torch.bfloat16,), q, k, v)
    if not (q.shape == k.shape == v.shape and packed_short_attention_eligible(q)):
        raise ValueError(f"packed_short_attention: unsupported shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    b, t, h, d = q.shape
    o = torch.empty(b, t, h, d, device=q.device, dtype=q.dtype)
    lib = _build.load()
    P = _build.ptr
    err = lib.mudg_packed_attn(P(q), P(k), P(v), P(o), b, t, h, d, *_strides(q, k, v),
                               _build.stream())
    _build.check(err, "packed_short_attention")
    packed_launches += 1
    return o


class _ShortAttention(torch.autograd.Function):
    """`forward` (either kernel's wrapper) with the dense math's gradient."""

    @staticmethod
    def forward(ctx, forward, q, k, v):
        ctx.save_for_backward(q, k, v)
        # no JAX tag: only remat="except_ff" keeps its output
        return R.kernel_outputs((), lambda: (forward(q, k, v),))[0]

    @staticmethod
    def backward(ctx, g):
        return (None, *plain_attention_bwd(*ctx.saved_tensors, g))


def short_kv_attention_op(q, k, v):
    """`short_kv_attention` with the dense math's gradient to q, k and v."""
    return _ShortAttention.apply(short_kv_attention, q, k, v)


def packed_short_attention_op(q, k, v):
    """`packed_short_attention` with the dense math's gradient to q, k and v."""
    return _ShortAttention.apply(packed_short_attention, q, k, v)
