"""Kernel 1: the fused spatial self-attention block (CUDA, `csrc/spatial_attn.cu`).

Computes LN -> q/k/v (C x C, no qkv bias) -> per-head softmax over the whole
sequence -> P @ V -> out-projection + bias -> + x over tokens (B, L, C), heads
of d = 64. Replaces `mudg_tpu/kernels/spatial_attn.py:_kernel`
(fused_self_attention) and its long-L tiers `_stream_kernel` and `_fb_kernel`
(MDM1024 ds2 and ds1), which compute the same function; what bounds it on
the H100 and how the CUDA design answers that is in the note at the top of
the .cu file: kernel 11's LayerNorm, the q|k|v and out-projection GEMMs on
`csrc/wgmma_gemm.cuh` and kernel 5's TMA + wgmma attention core
(`csrc/flash_fwd.cuh`) with the softmax scale already in Wq (qscale 1).

`fused_self_attention` is the wrapper: on a CPU (or meta) tensor it runs
`plain_self_attention`, the unfused reference math (the JAX `_xla_impl`); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from . import _build
from ..utils import profiling

LOG2E = 1.4426950408889634
# The JAX dispatch sends C = 1280 (ds4 L=160 and the middle block) to XLA
# (`_pick_bq(160, 1280) == 0`); the port keeps the same sites until H100
# numbers decide otherwise.
MAX_C = 640

launches = 0   # calls of the wrapper that launched the kernel


class PackedStage(NamedTuple):
    """Kernel-side weights of one LN -> self-attention -> out-proj stage,
    prepared once at load time (also used by kernel 2)."""
    ln_w: torch.Tensor   # (C,) fp32
    ln_b: torch.Tensor   # (C,) fp32
    wqkv: torch.Tensor   # (3C, C) bf16, Wq scaled by d^-0.5 * log2(e)
    wo: torch.Tensor     # (C, C) bf16
    bo: torch.Tensor     # (C,) fp32


def pack_stage_params(ln_w, ln_b, wq, wk, wv, wo, bo, heads: int) -> PackedStage:
    """Kernel-side weights from one stage's parameters (torch (out, in)
    layouts, bo may be None). The softmax scale and log2(e) are folded into
    Wq in bf16, as the TPU kernel does (spatial_attn.py:101-102)."""
    c = wq.shape[1]
    d = c // heads
    bf = torch.bfloat16
    wq2 = (wq.float() * (d ** -0.5 * LOG2E)).to(bf)
    wqkv = torch.cat([wq2, wk.to(bf), wv.to(bf)]).contiguous()
    bo = bo if bo is not None else wo.new_zeros(c)
    return PackedStage(ln_w.float().contiguous(), ln_b.float().contiguous(), wqkv,
                       wo.to(bf).contiguous(), bo.float().contiguous())


@torch.no_grad()
def pack_stage(norm, attn, heads: int) -> PackedStage:
    """norm: LayerNorm module; attn: CrossAttention module (self-attention,
    no q/k/v biases); packed once for inference."""
    out = attn.to_out["0"]
    return pack_stage_params(norm.weight, norm.bias, attn.to_q.weight, attn.to_k.weight,
                             attn.to_v.weight, out.weight, out.bias, heads)


def eligible(shape, dtype, c: int, heads: int) -> bool:
    """Dispatch predicate for tokens of `shape` (B, L, C)."""
    _, l, cc = shape
    return (dtype == torch.bfloat16 and cc == c == heads * 64
            and l % 64 == 0 and c <= MAX_C)


# The JAX package's three tiers of this function and their predicates
# (mudg_tpu/kernels/spatial_attn.py:111-153, :316-345, :491-525), copied
# without their TPU-backend term: the VMEM budgets pick which tier a shape
# takes on the TPU. The CUDA kernel serves all three (and every shape
# `eligible` admits); the dispatch uses these copies only to name a site's
# tier, so that MUDG_STREAM_SPATIAL=0 and MUDG_FLASHBLOCK=0 send exactly the
# sites JAX sends elsewhere (`switched_off`).
STREAM_BQ = 128


def _vmem_est(l, c, bq):
    return ((l * c * 2) * 2 + 2 * l * c * 2 + bq * l * 4 + 2 * 4 * c * c * 2
            + 2 * bq * c * 4 + 2 * bq * c * 4)


def _pick_bq(l, c):
    for bq in (l, 512, 320, 256, 128):
        if l % bq == 0 and _vmem_est(l, c, bq) < 12 * 2**20:
            return bq
    return 0


def _tier_common(dtype, c, heads):
    return dtype == torch.bfloat16 and c % heads == 0 and (c // heads) % 64 == 0


def whole_eligible(shape, dtype, c, heads) -> bool:
    """JAX `eligible`: the whole-block tier."""
    l = shape[1]
    return _tier_common(dtype, c, heads) and l % 128 == 0 and _pick_bq(l, c) > 0


def _stream_vmem_est(l, c, bq=STREAM_BQ):
    return 2 * l * c * 2 + 4 * c * c * 2 + 4 * bq * c * 2 + 2 * bq * l * 4 + 4 * bq * c * 4


def stream_eligible(shape, dtype, c, heads) -> bool:
    """JAX `stream_eligible`: the streamed tier."""
    l = shape[1]
    return (_tier_common(dtype, c, heads) and l % STREAM_BQ == 0
            and l // STREAM_BQ >= 2 and c % 128 == 0
            and _stream_vmem_est(l, c) < int(14.5 * 2**20))


def _fb_cpad(c):
    return (c + 127) // 128 * 128


def _fb_pick(l, c, heads):
    cp = _fb_cpad(c)
    for bq in (512, 256, 128):
        if l % bq:
            continue
        for bkv in (2048, 1536, 1152, 1024, 768, 512):
            if l % bkv or l // bkv < 2:
                continue
            est = (2 * 2 * bkv * cp * 2 + 2 * bq * bkv * 4 + 3 * bq * c * 4
                   + 2 * 2 * c * c * 2 + 2 * 2 * bq * c * 2 * 2 + 3 * bq * c * 4)
            if est < int(14.5 * 2**20):
                return bq, bkv
    return 0, 0


def flashblock_eligible(shape, dtype, c, heads) -> bool:
    """JAX `flashblock_eligible`: the flash-blocked tier."""
    return _tier_common(dtype, c, heads) and _fb_pick(shape[1], c, heads)[0] > 0


def tier(shape, dtype, c: int, heads: int):
    """The tier JAX puts a spatial self-attention site of tokens `shape`
    (B, L, C) on: "fused", "stream", "flashblock" or None, in JAX's order
    and under its switches (mudg_tpu/nn/attention.py:383-405)."""
    if whole_eligible(shape, dtype, c, heads):
        return "fused"
    if (stream_eligible(shape, dtype, c, heads)
            and os.environ.get("MUDG_STREAM_SPATIAL", "1") == "1"):
        return "stream"
    if (flashblock_eligible(shape, dtype, c, heads)
            and os.environ.get("MUDG_FLASHBLOCK", "1") == "1"):
        return "flashblock"
    return None


def switched_off(shape, dtype, c: int, heads: int) -> bool:
    """True where JAX would put the site on its streamed or flash-blocked
    tier but MUDG_STREAM_SPATIAL=0 / MUDG_FLASHBLOCK=0 leave it no tier, so
    JAX sends it to `cross_attention`."""
    return tier(shape, dtype, c, heads) is None and (
        stream_eligible(shape, dtype, c, heads) or flashblock_eligible(shape, dtype, c, heads))


def plain_self_attention(x, norm, attn, heads: int):
    """The reference math in plain PyTorch: LN -> self-attention -> + x."""
    from ..nn import attention as A
    from ..nn import functional as F

    return A.cross_attention(attn, F.layer_norm(norm, x), None, heads=heads,
                             impl="plain") + x


def check_packed(p: PackedStage, c: int) -> None:
    for name, t, dt, shape in (("ln_w", p.ln_w, torch.float32, (c,)),
                               ("ln_b", p.ln_b, torch.float32, (c,)),
                               ("wqkv", p.wqkv, torch.bfloat16, (3 * c, c)),
                               ("wo", p.wo, torch.bfloat16, (c, c)),
                               ("bo", p.bo, torch.float32, (c,))):
        _build.require(t, name, dt)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")


def fused_self_attention(x, norm, attn, heads: int, packed: PackedStage | None = None):
    """LN -> self-attention -> + x over x (B, L, C)."""
    global launches
    if x.device.type in ("cpu", "meta"):
        return plain_self_attention(x, norm, attn, heads)
    if packed is None:
        raise RuntimeError("spatial_attn: kernel weights not prepared "
                           "(call mudg_tpu_torch.kernels.prepare_kernels)")
    b, l, c = x.shape
    if not eligible(x.shape, x.dtype, c, heads):
        raise ValueError(f"spatial_attn: unsupported input {tuple(x.shape)} "
                         f"{x.dtype} with {heads} heads")
    _build.require(x, "x")
    check_packed(packed, c)
    lib = _build.load()
    rows = b * l
    out = torch.empty_like(x)
    xn = x.new_empty(rows, c)        # LN(x), then the attention output
    qkv = x.new_empty(rows, 3 * c)
    P = _build.ptr
    with profiling.span("kernel.spatial_attn"):
        err = lib.mudg_spatial_attn(P(x), P(out), P(xn), P(qkv), P(packed.ln_w),
                                    P(packed.ln_b), P(packed.wqkv), P(packed.wo), P(packed.bo),
                                    b, l, c, _build.stream())
    _build.check(err, "spatial_attn")
    launches += 1
    return out
