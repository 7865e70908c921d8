"""Kernel 3: the fused GEGLU feed-forward (CUDA, `csrc/geglu_ff.cu` on the TMA +
wgmma GEMM of `csrc/wgmma_gemm.cuh`), and kernel 10: its backward
(`csrc/mlp_bwd.cu`).

`[LN](x) @ W1 + b1 -> u * gelu_erf(g) -> @ W2 + b2 [+ x]` with W1's outputs
[value | gate]. Two variants, as in the JAX package: the block form with the
pre-LN and the residual (`fused_geglu_ff_block`, replaces
`mudg_tpu/kernels/mlp.py:_ff_ln_kernel`) and the bare form
(`fused_geglu_ff`, replaces `:_ff_kernel`). The design note is at the top of
the .cu file.

On a CPU (or meta) tensor a wrapper runs its plain version (the JAX
`_ff_block_math` / `_ff_math`; `plain_geglu_ff_bwd`, the JAX `_ff_bwd_kernel`
math); on a CUDA tensor it launches the kernel or raises. Both forward
variants add to the one `launches` count. `geglu_ff_train` and
`geglu_ff_block_train` are the ops with a gradient (`torch.autograd.Function`s
over the modules' fp32 parameters, packed inside the call): kernel 3 forward,
kernel 10 backward; the block form recomputes the LN and takes its backward
and the residual's in plain torch, as the JAX package does
(`_ff_block_vjp_bwd`, mlp.py:271-304).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build
from ..nn import remat as R

launches = 0       # forward calls that launched kernel 3
bwd_launches = 0   # backward calls that launched kernel 10
# the remat tags whose keeping keeps the training ops' outputs (nn/remat.py):
# the FF's output makes the transformer block's blk_ff, so the JAX replay
# drops kernel 3's forward wherever the policy keeps that tag
KEEP = (("blk_ff",),)


class PackedFF(NamedTuple):
    """Kernel-side FF weights, prepared once at load time. W1 (2*inner, C)
    and W2 (C, inner) are already the (N, K) layout the GEMM reads."""
    ln_w: torch.Tensor   # (C,) fp32
    ln_b: torch.Tensor   # (C,) fp32
    w1: torch.Tensor     # (2*inner, C) bf16, rows [value | gate]
    b1: torch.Tensor     # (2*inner,) fp32
    w2: torch.Tensor     # (C, inner) bf16
    b2: torch.Tensor     # (C,) fp32


def pack_ff_params(ln_w, ln_b, w1, b1, w2, b2) -> PackedFF:
    """Kernel-side weights from the parameters (torch layouts; ln_w/ln_b may
    be None for the bare form, biases may be None)."""
    bf = torch.bfloat16

    def f32(v, n):
        return (v if v is not None else w1.new_zeros(n)).float().contiguous()

    c = w1.shape[1]
    return PackedFF(f32(ln_w, c), f32(ln_b, c), w1.to(bf).contiguous(), f32(b1, w1.shape[0]),
                    w2.to(bf).contiguous(), f32(b2, w2.shape[0]))


def ff_params(ff):
    """(W1, b1, W2, b2) of a FeedForward module, its fp32 parameters."""
    proj, out = ff.net["0"].proj, ff.net["2"]
    return proj.weight, proj.bias, out.weight, out.bias


@torch.no_grad()
def pack_ff(ff, norm) -> PackedFF:
    """ff: FeedForward module (net.0.proj, net.2); norm: its pre-LayerNorm;
    packed once for inference."""
    return pack_ff_params(norm.weight, norm.bias, *ff_params(ff))


def eligible(shape, dtype, inner: int) -> bool:
    """Dispatch predicate for x of `shape` (..., C) (the JAX
    `geglu_ff_eligible`, with the GEMM's C % 32 in place of C % 8)."""
    m = 1
    for d in shape[:-1]:
        m *= d
    return (dtype == torch.bfloat16 and shape[-1] % 32 == 0
            and inner % 128 == 0 and m % 256 == 0)


def ff_bwd_eligible(m: int, c: int, inner: int) -> bool:
    """The training dispatch's second predicate: the JAX
    `_pick_block_sizes_bwd` / `ff_bwd_eligible` (mlp.py:388-418) arithmetic,
    copied. It admits the FF sites where the TPU's backward kernel fits VMEM,
    and so decides which FF sites train through kernels 3 and 10."""
    for s in (512, 384, 256, 128):
        if inner % s:
            continue
        for bm in (512, 256, 128):
            if m % bm:
                continue
            est = (6 * bm * s * 4 + 3 * c * s * 2 * 2 + 3 * c * s * 4 * 2
                   + 3 * bm * c * 2 * 2 + bm * c * 4)
            if est < (8 if c == 640 else 13) * 2**20:
                return True
    return False


def plain_geglu_ff(x, ff):
    """x @ W1 + b1 -> u * gelu(g) -> @ W2 + b2, in x's dtype."""
    return _plain_ff(x, *ff_params(ff))


def plain_geglu_ff_block(x, norm, ff):
    """LN (fp32 island, rounded to x's dtype) -> GEGLU FF -> + x."""
    return _plain_ff(_layer_norm(x, norm.weight, norm.bias), *ff_params(ff)) + x


def _launch(x, packed: PackedFF, block: bool):
    """Launch kernel 3 on x (..., C). It holds what the kernel requires (bf16,
    C % 32, inner % 128, at least one row); the rows % 256 of `eligible` is
    the dispatch's, since the kernel takes any row count (TMA's zero fill
    and clipped stores cover a partial row tile)."""
    global launches
    c = x.shape[-1]
    inner = packed.w2.shape[1]
    if not (x.dtype == torch.bfloat16 and c % 32 == 0 and inner % 128 == 0 and x.numel() > 0):
        raise ValueError(f"geglu_ff: unsupported input {tuple(x.shape)} {x.dtype}")
    _build.require(x, "x")
    for name, t, dt, shape in (("ln_w", packed.ln_w, torch.float32, (c,)),
                               ("ln_b", packed.ln_b, torch.float32, (c,)),
                               ("w1", packed.w1, torch.bfloat16, (2 * inner, c)),
                               ("b1", packed.b1, torch.float32, (2 * inner,)),
                               ("w2", packed.w2, torch.bfloat16, (c, inner)),
                               ("b2", packed.b2, torch.float32, (c,))):
        _build.require(t, name, dt)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    lib = _build.load()
    rows = x.numel() // c
    out = torch.empty_like(x)
    h = x.new_empty(rows, inner)
    xn = x.new_empty(rows, c) if block else None
    P = _build.ptr
    err = lib.mudg_geglu_ff(P(x), P(out), P(h), P(xn),
                            P(packed.ln_w) if block else None,
                            P(packed.ln_b) if block else None,
                            P(packed.w1), P(packed.b1), P(packed.w2), P(packed.b2),
                            rows, c, inner, _build.stream())
    _build.check(err, "geglu_ff")
    launches += 1
    return out


def fused_geglu_ff_block(x, norm, ff, packed: PackedFF | None = None):
    """LN(x) -> GEGLU FF -> + x, fused. x: (..., C)."""
    if x.device.type in ("cpu", "meta"):
        return plain_geglu_ff_block(x, norm, ff)
    if packed is None:
        raise RuntimeError("geglu_ff: kernel weights not prepared "
                           "(call mudg_tpu_torch.kernels.prepare_kernels)")
    return _launch(x, packed, block=True)


def fused_geglu_ff(x, ff, packed: PackedFF | None = None):
    """GEGLU FF without LN or residual. x: (..., C)."""
    if x.device.type in ("cpu", "meta"):
        return plain_geglu_ff(x, ff)
    if packed is None:
        raise RuntimeError("geglu_ff: kernel weights not prepared "
                           "(call mudg_tpu_torch.kernels.prepare_kernels)")
    return _launch(x, packed, block=False)


def plain_geglu_ff_bwd(x, dy, w1, b1, w2, *, drop_pdf_term=False):
    """Gradients of the bare GEGLU FF in plain torch, the JAX `_ff_bwd_kernel`
    math: u, g, dh and the GELU terms in fp32, h, du and dg rounded to x's
    dtype for their products. Returns (dx, dW1, db1, dW2, db2), the weight
    and bias gradients fp32 in torch layouts. `drop_pdf_term` plants a fault:
    dg loses its g * pdf(g) term."""
    dt = x.dtype
    c = x.shape[-1]
    inner = w2.shape[1]
    x2 = x.reshape(-1, c).float()
    dyf = dy.reshape(-1, c).float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    ug = x2 @ w1f.T + (b1.float() if b1 is not None else 0.0)
    u, g = ug[:, :inner], ug[:, inner:]
    phi = 0.5 * (1.0 + torch.erf(g * 2 ** -0.5))
    gelu = g * phi
    h = (u * gelu).to(dt).float()
    dh = dyf.to(dt).float() @ w2f
    du = dh * gelu
    slope = phi if drop_pdf_term else phi + g * torch.exp(-0.5 * g * g) / math.sqrt(2 * math.pi)
    dg = dh * u * slope
    dudg = torch.cat([du, dg], -1).to(dt).float()
    dx = (dudg @ w1f).to(dt).reshape(x.shape)
    return dx, dudg.T @ x2, torch.cat([du.sum(0), dg.sum(0)]), dyf.T @ h, dyf.sum(0)


def geglu_ff_bwd(x, dy, w1, b1, w2):
    """Gradients of the bare GEGLU FF for the upstream dy: (dx, dW1, db1,
    dW2, db2), x (..., C) and W1 (2*inner, C), W2 (C, inner) the fp32
    parameters (cast and packed here)."""
    global bwd_launches
    if x.device.type in ("cpu", "meta"):
        return plain_geglu_ff_bwd(x, dy, w1, b1, w2)
    c = x.shape[-1]
    inner = w2.shape[1]
    if not eligible(x.shape, x.dtype, inner):
        raise ValueError(f"geglu_ff_bwd: unsupported input {tuple(x.shape)} {x.dtype}")
    x, dy = x.contiguous(), dy.contiguous()
    _build.require(x, "x")
    _build.require(dy, "dy")
    rows = x.numel() // c
    bf = torch.bfloat16
    f32 = dict(device=x.device, dtype=torch.float32)
    w1b = w1.to(bf).contiguous()
    w1t = w1b.t().contiguous()
    w2t = w2.to(bf).t().contiguous()
    b1f = (b1 if b1 is not None else w1.new_zeros(2 * inner)).float().contiguous()
    dx = torch.empty_like(x)
    h = x.new_empty(rows, inner)
    dudg = x.new_empty(rows, 2 * inner)
    slab = torch.empty((rows + 63) // 64, 2 * inner, **f32)   # per 64-row tile: colsum du | dg
    dw1, dw2 = torch.empty(2 * inner, c, **f32), torch.empty(c, inner, **f32)
    db1, db2 = torch.empty(2 * inner, **f32), torch.empty(c, **f32)
    work = torch.empty(_build.WORK_ELEMS, **f32)
    P = _build.ptr
    err = _build.load().mudg_geglu_ff_bwd(
        P(x), P(dy), P(dx), P(w1b), P(b1f), P(w2t), P(w1t), P(h), P(dudg), P(slab),
        P(dw1), P(db1), P(dw2), P(db2), P(work), _build.WORK_ELEMS, rows, c, inner,
        _build.stream())
    _build.check(err, "geglu_ff_bwd")
    bwd_launches += 1
    return dx, dw1, db1, dw2, db2


class _GegluFF(torch.autograd.Function):
    """Kernel 3 (bare form) forward, kernel 10 backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)

        def launch():
            if x.device.type in ("cpu", "meta"):
                return (_plain_ff(x, w1, b1, w2, b2),)
            return (_launch(x.contiguous(), pack_ff_params(None, None, w1, b1, w2, b2),
                            block=False),)

        # its output + x is the block's blk_ff: kept with it
        return R.kernel_outputs(KEEP, launch)[0]

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        return geglu_ff_bwd(x, dy, w1, b1, w2)


class _GegluFFBlock(torch.autograd.Function):
    """Kernel 3 (block form) forward; backward: LN recomputed, kernel 10 on
    LN(x), the LN's backward and the residual in plain torch."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2)

        def launch():
            if x.device.type in ("cpu", "meta"):
                return (_plain_ff(_layer_norm(x, ln_w, ln_b), w1, b1, w2, b2) + x,)
            return (_launch(x.contiguous(), pack_ff_params(ln_w, ln_b, w1, b1, w2, b2),
                            block=True),)

        # its output is the block's blk_ff: kept with it
        return R.kernel_outputs(KEEP, launch)[0]

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, w1, b1, w2 = ctx.saved_tensors
        with torch.enable_grad():
            xr, lw, lb = (t.detach().requires_grad_() for t in (x, ln_w, ln_b))
            xn = _layer_norm(xr, lw, lb)
        dxn, dw1, db1, dw2, db2 = geglu_ff_bwd(xn.detach(), dy, w1, b1, w2)
        dx_ln, dlnw, dlnb = torch.autograd.grad(xn, (xr, lw, lb), dxn)
        return dx_ln + dy, dlnw, dlnb, dw1, db1, dw2, db2


def _layer_norm(x, w, b):
    """LayerNorm in fp32, rounded to x's dtype (nn.functional.layer_norm)."""
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                                          1e-5).to(x.dtype)


def _plain_ff(x, w1, b1, w2, b2):
    dt = x.dtype
    b1, b2 = (None if b is None else b.to(dt) for b in (b1, b2))
    u, g = torch.nn.functional.linear(x, w1.to(dt), b1).chunk(2, dim=-1)
    h = u * torch.nn.functional.gelu(g, approximate="none")
    return torch.nn.functional.linear(h, w2.to(dt), b2)


def geglu_ff_train(x, ff):
    """GEGLU FF over x (..., C) with the gradient to x and to ff's fp32
    parameters."""
    return _GegluFF.apply(x, *ff_params(ff))


def geglu_ff_block_train(x, norm, ff):
    """LN(x) -> GEGLU FF -> + x with the gradient to x, the LN's and ff's
    fp32 parameters."""
    return _GegluFFBlock.apply(x, norm.weight, norm.bias, *ff_params(ff))
