"""Kernel 5: flash attention forward with its logsumexp (CUDA, `csrc/flash_attn.cu`
in bf16, `csrc/flash_attn_f32.cu` in fp32), and kernel 6: its FlashAttention-2
backward (`csrc/flash_attn_bwd.cu`, `csrc/flash_attn_f32.cu`).

Computes o = softmax(q k^T / sqrt(64)) v and the natural-log logsumexp of
every row's logits over q, k, v (B, L, H, 64), non-causal, no bias, equal
lengths, L % 64 == 0, in bf16 or fp32 (the Pallas kernels take any dtype).
Replaces `mudg_tpu/kernels/flash_attention.py`'s forward (`_oneshot_kernel`,
`_fwd_kernel`) and backward (`_bwd_dq_kernel`, `_bwd_dkv_kernel` and their
chunked long-L bodies); what bounds each on the H100 and how the CUDA design
answers that is in the note at the top of its .cu file.

`flash_attention` and `flash_attention_bwd` are the wrappers: on a CPU (or
meta) tensor they run `plain_flash_attention` / `plain_flash_attention_bwd`;
on a CUDA tensor they launch the kernel of the tensor's dtype or raise. q, k
and v are read in place through their strides (no (B*H, L, D) fold).
`flash_attention_train` is the op with a gradient (a
`torch.autograd.Function` that saves q, k, v, o and lse), which the training
dispatch uses. `launches` and `bwd_launches` count both dtypes.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..nn import remat as R

D = 64          # head dim the kernel takes
launches = 0    # calls of the forward wrapper that launched kernel 5
bwd_launches = 0   # calls of the backward wrapper that launched kernel 6


DTYPES = (torch.bfloat16, torch.float32)


def eligible(q, k, v) -> bool:
    """Dispatch predicate for q, k, v of shape (B, L, H, D): bf16 or fp32,
    D = 64 and L % 64 == 0. The JAX predicate admits any D % 64 == 0; every
    MuDG attention at L >= 512 has D = 64, so the kernels take that one."""
    return (q.dtype == k.dtype == v.dtype and q.dtype in DTYPES and q.ndim == 4
            and q.shape == k.shape == v.shape and q.shape[-1] == D
            and q.shape[1] % 64 == 0)


def plain_flash_attention(q, k, v):
    """The reference math in plain PyTorch: (o (B, L, H, D), lse (B*H, L))."""
    from ..nn.attention import plain_attend

    return plain_attend(q, k, v, with_lse=True)


def _delta(o, do):
    """rowsum(o * dO) in fp32, (B*H, L), as XLA computes it outside the
    TPU kernels (the CUDA kernels compute it in their first pass)."""
    b, l, h, _ = o.shape
    return (o.float() * do.float()).sum(-1).permute(0, 2, 1).reshape(b * h, l).contiguous()


def plain_flash_attention_bwd(q, k, v, o, lse, do, *, delta=None):
    """FA-2 gradients (dq, dk, dv) in plain PyTorch, fp32 math, in q's dtype:
    P = exp(q k^T s - lse), dS = P (dO v^T - delta), dq = s dS k,
    dk = s dS^T q, dv = P^T dO with s = d^-0.5. k and v may be shorter than q
    (a planted fault walks half the keys). Walks chunks of the (batch, head)
    pairs as `plain_attend` does. `delta` defaults to rowsum(o * dO)."""
    from ..nn.attention import pair_chunks

    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5
    delta = _delta(o, do) if delta is None else delta
    lse4 = lse.reshape(b, h, lq, 1)
    dl4 = delta.reshape(b, h, lq, 1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bc, hc = pair_chunks(b, h, lq * lk * 16)
    for b0 in range(0, b, bc):
        for h0 in range(0, h, hc):
            sl = (slice(b0, b0 + bc), slice(None), slice(h0, h0 + hc))
            qf, kf, vf, dof = (t[sl].float() for t in (q, k, v, do))
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
            p = torch.exp(s - lse4[b0:b0 + bc, h0:h0 + hc])
            ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - dl4[b0:b0 + bc, h0:h0 + hc])
            dq[sl] = (scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)).to(q.dtype)
            dk[sl] = (scale * torch.einsum("bhqk,bqhd->bkhd", ds, qf)).to(k.dtype)
            dv[sl] = torch.einsum("bhqk,bqhd->bkhd", p, dof).to(v.dtype)
    return dq, dk, dv


def _check_operand(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.stride(-1) != 1 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
        raise ValueError(f"{name}: head dim must be contiguous and every stride "
                         f"a multiple of 16 bytes, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def _strides(*ts):
    return [ctypes.c_longlong(s) for t in ts for s in t.stride()[:3]]


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
    P = _build.ptr
    if q.dtype == torch.bfloat16:
        err = lib.mudg_flash_attn(P(q), P(k), P(v), P(o), P(lse), b, l, h, *_strides(q, k, v),
                                  _build.stream())
    else:
        # the kernels' first pass writes tf32 hi and lo copies of q (scaled), k and v^T
        work = torch.empty(3, 2, b * h, l, D, device=q.device, dtype=torch.float32)
        err = lib.mudg_flash_attn_f32(P(q), P(k), P(v), P(o), P(lse), P(work), b, l, h,
                                      *_strides(q, k, v), _build.stream())
    _build.check(err, "flash_attention")
    launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do):
    """Gradients (dq, dk, dv) of `flash_attention`'s o for the upstream dO,
    each (B, L, H, 64) in q's dtype, from the forward's o and lse."""
    global bwd_launches
    if q.device.type in ("cpu", "meta"):
        return plain_flash_attention_bwd(q, k, v, o, lse, do)
    if not eligible(q, k, v):
        raise ValueError(f"flash_attention_bwd: unsupported inputs {tuple(q.shape)} {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name)
    do = do.contiguous()
    b, l, h, _ = q.shape
    _build.require(do, "dO", q.dtype)
    for t, name in ((o, "o"), (do, "dO")):
        if t.shape != q.shape:
            raise ValueError(f"{name}: expected {tuple(q.shape)}, got {tuple(t.shape)}")
    _build.require(lse, "lse", torch.float32)
    if tuple(lse.shape) != (b * h, l):
        raise ValueError(f"lse: expected {(b * h, l)}, got {tuple(lse.shape)}")
    dq, dk, dv = (torch.empty(q.shape, device=q.device, dtype=q.dtype) for _ in range(3))
    lib = _build.load()
    P = _build.ptr
    # the kernels' first pass writes delta and, in bf16, a scaled copy of q,
    # in fp32 tf32 hi and lo copies of q (scaled), k, v, dO, q^T, k^T and dO^T
    o = o.contiguous()
    _build.require(o, "o", q.dtype)
    delta = torch.empty(b * h, l, device=q.device, dtype=torch.float32)
    if q.dtype == torch.bfloat16:
        qs = torch.empty(q.shape, device=q.device, dtype=q.dtype)
        err = lib.mudg_flash_attn_bwd(P(q), P(k), P(v), P(o), P(do), P(lse), P(delta), P(dq),
                                      P(dk), P(dv), P(qs), b, l, h, *_strides(q, k, v),
                                      _build.stream())
    else:
        work = torch.empty(7, 2, b * h, l, D, device=q.device, dtype=torch.float32)
        err = lib.mudg_flash_attn_bwd_f32(P(q), P(k), P(v), P(o), P(do), P(lse), P(delta),
                                          P(dq), P(dk), P(dv), P(work), b, l, h,
                                          *_strides(q, k, v), _build.stream())
    _build.check(err, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Kernel 5 forward, kernel 6 backward (the JAX package's `_attach_grad`)."""

    @staticmethod
    def forward(ctx, q, k, v):
        # attn_o, attn_lse: kept by remat="dots_attn", whose replay then
        # launches no kernel 5
        o, lse = R.kernel_outputs((("attn_o",), ("attn_lse",)), lambda: flash_attention(q, k, v))
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do)


def flash_attention_train(q, k, v):
    """`flash_attention`'s o with the FlashAttention-2 gradient to q, k, v
    (o and lse tagged attn_o / attn_lse, mudg_tpu/kernels/flash_attention.py:454-455)."""
    R.tag("attn_o", "attn_lse")
    return _FlashAttention.apply(q, k, v)
