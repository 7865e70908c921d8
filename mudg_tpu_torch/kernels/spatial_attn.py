"""Kernel 1: the fused spatial self-attention block (CUDA, `csrc/spatial_attn.cu`).

Computes LN -> q/k/v (C x C, no qkv bias) -> per-head softmax over the whole
sequence -> P @ V -> out-projection + bias -> + x over tokens (B, L, C), heads
of d = 64. Replaces `mudg_tpu/kernels/spatial_attn.py:_kernel`
(fused_self_attention) and its long-L tiers `_stream_kernel` and `_fb_kernel`
(MDM1024 ds2 and ds1), which compute the same function; what bounds it on
the H100 and how the CUDA design answers that is in the note at the top of
the .cu file.

`fused_self_attention` is the wrapper: on a CPU (or meta) tensor it runs
`plain_self_attention`, the unfused reference math (the JAX `_xla_impl`); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

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
    qkv = x.new_empty(rows, 3 * c)
    o = x.new_empty(rows, c)
    mean = torch.empty(rows, device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    P = _build.ptr
    err = lib.mudg_spatial_attn(P(x), P(out), P(qkv), P(o), P(mean), P(rstd),
                                P(packed.ln_w), P(packed.ln_b), P(packed.wqkv),
                                P(packed.wo), P(packed.bo), b, l, c, _build.stream())
    _build.check(err, "spatial_attn")
    launches += 1
    return out
