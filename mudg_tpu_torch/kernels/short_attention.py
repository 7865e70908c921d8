"""Kernel 12: attention over short sequences (CUDA, `csrc/short_kv.cu`,
`csrc/short_kv_f32.cu` and `csrc/short_attn.cu`).

`short_kv_attention`: q (B, Lq, H, D) over a small K/V (B, Lk, H, D),
Lk <= 1024 (the UNet's text and image cross-attention).
`packed_short_attention`: self-attention over each (b, h) sequence of q, k,
v (B, T, H, D), T <= 64 (the temporal-attention shape). Both non-causal, fp32 softmax,
probabilities cast to v's dtype for the P @ V product. Replace
`mudg_tpu/kernels/short_attention.py`'s `_short_kv_kernel` (pallas_call at
:214) and `_packed_kernel` (:81); the design notes are at the top of the .cu
files. Every kernel is TMA-fed; `short_kv_route` picks the file (bf16
`short_kv.cu`, fp32 `short_kv_f32.cu`) and `short_kv_plan` the kernel and
its launch: K/V held whole in shared memory up to 128 keys (fp32: at head
dim 64), every MuDG site, else streamed in key chunks with an online
softmax. `packed_plan` plans the packed kernel (`short_attn.cu`, items of
whole sequences through a ring of TMA boxes). The plans are pure Python
(tests/test_torch_short_plan.py holds them at every admitted shape); the C
launchers check what they are given.

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

Known difference: the streamed bf16 kernel (Lk > 128) rounds P to bf16
before it normalises it (one pass over the keys, as kernel 5 does); the
Pallas kernel normalises first. Both are within the bf16 tolerance.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from ..utils import profiling
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


SMEM_MAX = 232448   # bytes of shared memory one block may use (227 KB)
SMS = 132           # streaming multiprocessors of an H100 SXM (the plans' default)
SK_BOX = 64 * 64 * 2   # bytes of one TMA box of 64 rows by 64 bf16 columns
SKV_WHOLE_MAX_KEYS = 128   # K and V held whole up to this (fp32: at head dim 64), else chunked


def short_kv_route(dtype, d: int, lk: int) -> str:
    """Which file's kernels a short-KV call launches: "tma" in bf16
    (`csrc/short_kv.cu`: TMA + wgmma, K/V held whole up to 128 keys, else
    streamed in 64-key chunks with an online softmax), "tf32" in fp32
    (`csrc/short_kv_f32.cu`: every product three tf32 wgmma products; K and
    V^T split once per pair into hi and lo copies held whole at head dim
    64 and Lk <= 128, else split chunk by chunk as they land, with an online
    softmax). `short_kv_plan` says which kernel of the file and how."""
    return "tma" if dtype == torch.bfloat16 else "tf32"


def _divisors(upto: int, n: int) -> list[int]:
    """The divisors of n up to `upto`."""
    return [i for i in range(1, upto + 1) if n % i == 0]


class PackedPlan(NamedTuple):
    """A packed launch (`csrc/short_attn.cu`): items of `hg` heads by `bg`
    batch rows (whole sequences, `rows` = bg * T * hg rows a tensor, a
    multiple of 16), each read as TMA boxes of (64 head dims, hg, T, bg);
    `stages` items in flight; `grid` persistent blocks; `smem` bytes."""
    hg: int
    bg: int
    rows: int
    items: int
    stages: int
    smem: int
    grid: int
    box: tuple   # (64, hg, T, bg): the tensor map's box, innermost first


PACKED_BOX_BYTES = 16384   # one tensor's box of an item, at most
PACKED_STAGES = 6          # items in flight, at most


def packed_smem(rows: int, d: int, stages: int) -> int:
    """`csrc/short_attn.cu:packed_smem`: the ring and its barriers."""
    return 1024 + stages * 3 * rows * d * 2 + stages * 16


@functools.lru_cache(maxsize=None)
def packed_plan(b: int, t: int, h: int, d: int, sms: int = SMS) -> PackedPlan:
    """The packed kernel's plan for q (b, t, h, d): items of whole sequences
    (hg dividing h, bg dividing b, at most PACKED_BOX_BYTES a tensor, rows a
    multiple of 16), the most heads first (a batch row's runs of hg x D are
    contiguous in memory), then the most rows; where no such pair exists
    (T < 16), 16 / T heads of one batch row, the heads past h read as zeros
    and not stored."""
    rows_max = PACKED_BOX_BYTES // (2 * d)
    best = None
    for hg in _divisors(min(h, 256), h):
        for bg in _divisors(min(b, rows_max), b):
            rows = bg * t * hg
            if rows <= rows_max and rows % 16 == 0 and hg <= 256 and bg <= 256:
                best = max(best or (0, 0, 0), (hg, rows, bg))
    hg, rows, bg = best or (16 // t, 16, 1)
    stages = min(PACKED_STAGES, (SMEM_MAX - 1024) // (3 * rows * d * 2 + 16))
    items = -(-h // hg) * -(-b // bg)
    return PackedPlan(hg, bg, rows, items, stages, packed_smem(rows, d, stages),
                      min(items, sms), (64, hg, t, bg))


class ShortKvPlan(NamedTuple):
    """A short-KV launch: `route` (short_kv_route); `chunked` if K and V
    stream through a ring of `keys`-key chunks (else `keys` is the Lk
    rounded up to 16 that stay whole in shared memory); `stages` q tiles
    (whole) or chunks (chunked) in flight; `span` q tiles a block (whole)
    or (batch, head, tile pair) items in all (chunked); `grid` blocks;
    `smem` bytes a block; `box` the tensor maps' box, innermost first.
    Chunked bf16 items are SK_STREAM_WGS[d] consecutive q tiles of one
    (batch, head) pair, one a consumer warpgroup."""
    route: str
    chunked: bool
    keys: int
    stages: int
    span: int
    grid: int
    smem: int
    box: tuple


SK_STAGES = 4            # q tiles in flight with K/V whole
SK_STREAM_STAGES = 6     # K|V chunks in flight, at most
# whole K/V: blocks wanted per SM in all, by head dim (two blocks share an
# SM at D 64; one holds it at D 128, where fewer, longer spans load each
# pair's K and V fewer times)
SK_BLOCKS_PER_SM = {64: 8, 128: 4}
SK_STREAM_WGS = {64: 3, 128: 2}   # streamed K/V: consumer warpgroups, q tiles an item


@functools.lru_cache(maxsize=None)
def short_kv_plan(dtype, b: int, lq: int, lk: int, h: int, d: int,
                  sms: int = SMS) -> ShortKvPlan:
    """The launch of `short_kv_route(dtype, d, lk)` for q (b, lq, h, d) over
    k, v (b, lk, h, d) (`csrc/short_kv.cu` and `short_kv_f32.cu` check the
    same sizes)."""
    route = short_kv_route(dtype, d, lk)
    tiles, nk = lq // 64, -(-lk // 16) * 16
    cb = d // 64
    if route == "tma" and lk <= SKV_WHOLE_MAX_KEYS:
        # each block takes `span` consecutive q tiles of one (batch, head)
        # pair, about SK_BLOCKS_PER_SM blocks per SM in all: the last wave
        # is a small part of the call, while each block's one K/V load
        # serves several tiles
        want = -(-SK_BLOCKS_PER_SM[d] * sms // (b * h))
        span = max(1, tiles // want)
        smem = 1024 + cb * (2 * -(-nk // 64) + SK_STAGES + 2) * SK_BOX + 8 * (1 + 2 * SK_STAGES)
        return ShortKvPlan(route, False, nk, SK_STAGES, span, -(-tiles // span) * h * b, smem,
                           (64, 1, 64, 1))
    if route == "tma":
        wgs = SK_STREAM_WGS[d]

        def smem(s):
            return 1024 + cb * (3 * wgs + 2 * s) * SK_BOX + 8 * (4 + 2 * s)
        stages = max(s for s in range(2, SK_STREAM_STAGES + 1) if smem(s) <= SMEM_MAX)
        items = b * h * -(-tiles // wgs)
        return ShortKvPlan(route, True, 64, stages, items, min(items, sms), smem(stages),
                           (64, 1, 64, 1))
    if d == 64 and lk <= SKV_WHOLE_MAX_KEYS:   # csrc/short_kv_f32.cu's launcher sizes this
        stages = 4 if nk <= 96 else 2
        smem = 1024 + 2 * nk * 256 + 2 * -(-nk // 32) * 8192 + 2 * nk * 256 + stages * 16384 + 256
        total = b * h * tiles
        span = -(-total // sms)
        return ShortKvPlan(route, False, nk, stages, span, -(-total // span), smem,
                           (32, 1, 64, 1))
    keys = 64 if d == 64 else 32   # `sc_keys`: q hi and lo, a split chunk, a raw chunk
    items = b * h * (tiles // 2)
    return ShortKvPlan(route, True, keys, 2, items, min(items, sms),
                       1024 + 4 * 64 * d * 4 + 6 * keys * d * 4 + 16, (32, 1, keys, 1))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t) -> int:
    """SMs of the card t lies on (the plans' default for any other tensor)."""
    if t.device.type != "cuda":
        return SMS
    return _sm_count(t.device.index if t.device.index is not None else
                     torch.cuda.current_device())


def plan_text(q, k=None) -> str:
    """The launch plan of a short-KV call (q, k) or a packed call (q), as
    chip_smoke.py prints it beside each case."""
    if k is None:
        p = packed_plan(*q.shape, sms=sm_count(q))
        return (f"items of {p.hg} heads x {p.bg} batch rows ({p.rows} rows), {p.items} items, "
                f"{p.stages} stages, grid {p.grid}, {p.smem} B")
    b, lq, h, d = q.shape
    p = short_kv_plan(q.dtype, b, lq, k.shape[1], h, d, sms=sm_count(q))
    return (f"{p.route}, {'chunks of' if p.chunked else 'whole'} {p.keys} keys, {p.stages} "
            f"stages, span {p.span}, grid {p.grid}, {p.smem} B")


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
    """Raise on what the kernels do not take; else the (batch, sequence,
    head) element strides of q, k and v, as the C entries take them."""
    strides = []
    for t, what in zip(ts, "qkv"):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device}")
        if t.dtype not in dtypes or t.dtype != ts[0].dtype:
            raise ValueError(f"{name}: {what} must be one of {dtypes} as q is, got {t.dtype}")
        if t.ndim != 4 or t.shape[3] not in (64, 128):
            raise ValueError(f"{name}: {what} must be (B, L, H, 64 or 128), got "
                             f"{tuple(t.shape)}")
        sb, sl, sh, sd = t.stride()
        if sd != 1 or sb % 8 or sl % 8 or sh % 8:
            raise ValueError(f"{name}: {what}'s head dim must be contiguous and every "
                             f"stride a multiple of 8, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what}'s data pointer is not 16-byte aligned")
        strides += (sb, sl, sh)
    return strides


def short_kv_attention(q, k, v):
    """Attention of q (B, Lq, H, D) over k, v (B, Lk, H, D) -> (B, Lq, H, D)."""
    global launches
    if q.device.type in ("cpu", "meta"):
        return plain_short_attention(q, k, v)
    strides = _check_operands("short_kv_attention", (torch.bfloat16, torch.float32), q, k, v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d) or lk < 1
            or not short_kv_attention_eligible(q, k)):
        raise ValueError(f"short_kv_attention: unsupported shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    o = torch.empty(b, lq, h, d, device=q.device, dtype=q.dtype)
    lib = _build.load()
    P = _build.ptr
    plan = short_kv_plan(q.dtype, b, lq, lk, h, d, sm_count(q))
    with profiling.span("kernel.short_kv_attention"):
        if plan.route == "tma":
            err = lib.mudg_short_kv_tma(P(q), P(k), P(v), P(o), b, lq, lk, h, d, plan.span,
                                        plan.stages, plan.grid, *strides, _build.stream())
        elif plan.chunked:
            err = lib.mudg_short_kv_tf32_chunked(P(q), P(k), P(v), P(o), b, lq, lk, h, d,
                                                 plan.grid, *strides, _build.stream())
        else:
            err = lib.mudg_short_kv_tf32(P(q), P(k), P(v), P(o), b, lq, lk, h, d,
                                         *strides, _build.stream())
    _build.check(err, "short_kv_attention")
    launches += 1
    return o


def packed_short_attention(q, k, v):
    """Self-attention over each (b, h) sequence of q, k, v (B, T, H, D)."""
    global packed_launches
    if q.device.type in ("cpu", "meta"):
        return plain_short_attention(q, k, v)
    strides = _check_operands("packed_short_attention", (torch.bfloat16,), q, k, v)
    if not (q.shape == k.shape == v.shape and packed_short_attention_eligible(q)):
        raise ValueError(f"packed_short_attention: unsupported shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    b, t, h, d = q.shape
    o = torch.empty(b, t, h, d, device=q.device, dtype=q.dtype)
    lib = _build.load()
    P = _build.ptr
    plan = packed_plan(b, t, h, d, sm_count(q))
    with profiling.span("kernel.packed_short_attention"):
        err = lib.mudg_packed_attn(P(q), P(k), P(v), P(o), b, t, h, d, plan.hg, plan.bg,
                                   plan.stages, plan.grid, *strides, _build.stream())
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
