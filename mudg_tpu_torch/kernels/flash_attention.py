"""Kernel 5: flash attention forward with its logsumexp (CUDA, `csrc/flash_attn.cu`).

Computes o = softmax(q k^T / sqrt(64)) v and the natural-log logsumexp of
every row's logits over q, k, v (B, L, H, 64), non-causal, no bias, equal
lengths, L % 64 == 0. Replaces `mudg_tpu/kernels/flash_attention.py`'s
forward (`_oneshot_kernel`, `_fwd_kernel`); what bounds it on the H100 and
how the CUDA design answers that is in the note at the top of the .cu file.

`flash_attention` is the wrapper: on a CPU (or meta) tensor it runs
`plain_flash_attention`, the port's plain `attend` math with the logsumexp;
on a CUDA tensor it launches the kernel or raises. q, k and v are read in
place through their strides (no (B*H, L, D) fold).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

D = 64          # head dim the kernel takes
launches = 0    # calls of the wrapper that launched the kernel


def eligible(q, k, v) -> bool:
    """Dispatch predicate for q, k, v of shape (B, L, H, D)."""
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16 and q.ndim == 4
            and q.shape == k.shape == v.shape and q.shape[-1] == D
            and q.shape[1] % 64 == 0)


def plain_flash_attention(q, k, v):
    """The reference math in plain PyTorch: (o (B, L, H, D), lse (B*H, L))."""
    from ..nn.attention import plain_attend

    return plain_attend(q, k, v, with_lse=True)


def _check_operand(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name}: head dim must be contiguous and every stride "
                         f"a multiple of 8, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def flash_attention(q, k, v):
    """Attention over q, k, v (B, L, H, 64) -> (o (B, L, H, 64) in q's dtype,
    lse (B*H, L) fp32, natural-log units)."""
    global launches
    if q.device.type in ("cpu", "meta"):
        return plain_flash_attention(q, k, v)
    if not eligible(q, k, v):
        raise ValueError(f"flash_attention: unsupported inputs {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)} {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name)
    b, l, h, d = q.shape
    o = torch.empty(b, l, h, d, device=q.device, dtype=q.dtype)
    lse = torch.empty(b * h, l, device=q.device, dtype=torch.float32)
    lib = _build.load()
    strides = [ctypes.c_longlong(s) for t in (q, k, v) for s in t.stride()[:3]]
    P = _build.ptr
    err = lib.mudg_flash_attn(P(q), P(k), P(v), P(o), P(lse), b, l, h, *strides,
                              _build.stream())
    _build.check(err, "flash_attention")
    launches += 1
    return o, lse
