"""Kernel 2: the fused temporal double self-attention (CUDA, `csrc/temporal_attn.cu`).

Two consecutive [LN -> self-attention over T = 16 -> out-projection + bias ->
+ residual] stages over tokens (N, T, C), heads of d = 64. Replaces
`mudg_tpu/kernels/temporal_attn.py:_kernel` / `_kernel1`
(fused_double_self_attn); the design note is at the top of the .cu file.

`fused_double_self_attn` is the wrapper: on a CPU (or meta) tensor it runs
`plain_double_self_attn` (the JAX `_xla_impl`); on a CUDA tensor it launches
the kernel, one stage per C call, or raises.
"""
from __future__ import annotations

import torch

from . import _build
from .spatial_attn import PackedStage, check_packed

T = 16          # sequence length the kernel takes: one 16-row mma tile
# The JAX dispatch keeps C = 1280 in XLA (`_pick_group(5120, 1280, 1) == 0`).
MAX_C = 640

launches = 0


def eligible(shape, dtype, c: int, heads: int) -> bool:
    """Dispatch predicate for tokens of `shape` (N, T, C)."""
    n, t, cc = shape
    return (dtype == torch.bfloat16 and t == T and cc == c == heads * 64
            and (n * t) % 64 == 0 and c <= MAX_C)


def plain_double_self_attn(tokens, stage1, stage2, heads: int):
    """Reference math: stage(stage(tokens)) with stage = LN -> self-attn -> +x.
    stage1/stage2: (LayerNorm module, CrossAttention module)."""
    from ..nn import attention as A
    from ..nn import functional as F

    x = tokens
    for norm, attn in (stage1, stage2):
        x = A.cross_attention(attn, F.layer_norm(norm, x), None, heads=heads,
                              impl="plain") + x
    return x


def fused_double_self_attn(tokens, stage1, stage2, heads: int,
                           packed: tuple[PackedStage, PackedStage] | None = None):
    """Both LN -> self-attn -> + residual stages over tokens (N, T, C)."""
    global launches
    if tokens.device.type in ("cpu", "meta"):
        return plain_double_self_attn(tokens, stage1, stage2, heads)
    if packed is None:
        raise RuntimeError("temporal_attn: kernel weights not prepared "
                           "(call mudg_tpu_torch.kernels.prepare_kernels)")
    n, t, c = tokens.shape
    if not eligible(tokens.shape, tokens.dtype, c, heads):
        raise ValueError(f"temporal_attn: unsupported input {tuple(tokens.shape)} "
                         f"{tokens.dtype} with {heads} heads")
    _build.require(tokens, "tokens")
    for p in packed:
        check_packed(p, c)
    lib = _build.load()
    rows = n * t
    h1 = torch.empty_like(tokens)
    out = torch.empty_like(tokens)
    qkv = tokens.new_empty(rows, 3 * c)
    o = tokens.new_empty(rows, c)
    mean = torch.empty(rows, device=tokens.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    P = _build.ptr
    for src, dst, p in ((tokens, h1, packed[0]), (h1, out, packed[1])):
        err = lib.mudg_temporal_attn_stage(
            P(src), P(dst), P(qkv), P(o), P(mean), P(rstd), P(p.ln_w), P(p.ln_b),
            P(p.wqkv), P(p.wo), P(p.bo), rows, c, _build.stream())
        _build.check(err, "temporal_attn")
    launches += 1
    return out
