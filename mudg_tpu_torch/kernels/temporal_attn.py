"""Kernel 2: the fused temporal double self-attention (CUDA, `csrc/temporal_attn.cu`),
and kernel 9: one stage's backward (`csrc/temporal_attn_bwd.cu`).

Two consecutive [LN -> self-attention over T = 16 -> out-projection + bias ->
+ residual] stages over tokens (N, T, C), heads of d = 64. Replaces
`mudg_tpu/kernels/temporal_attn.py:_kernel` / `_kernel1`
(fused_double_self_attn) and `_bwd_stage_kernel` (`_bwd_one_stage`); the
design notes are at the top of the .cu files.

Kernels 2 and 9 read Wq|Wk|Wv packed per head, rows 192 h .. 192 h + 191 =
[Wq'_h | Wk_h | Wv_h] (`pack_stage`, `pack_stage_params`): one tile of their
q|k|v GEMM is 64 rows by one head, whose attention (forward, or backward)
runs in the GEMM's epilogue. Kernel 9 returns the gradient of that packed
matrix in the same head order; `_launch_stage_bwd` restores [q | k | v].

`fused_double_self_attn` (inference, weights packed once by
`prepare_kernels`) and `double_self_attn_bwd` are the wrappers: on a CPU (or
meta) tensor they run the plain versions (`plain_double_self_attn`, the JAX
`_xla_impl`; `plain_temporal_stage_bwd`, the JAX `_bwd_stage_kernel` math);
on a CUDA tensor they launch the kernel, one stage per C call, or raise.
`double_self_attn_train` is the op with a gradient: a
`torch.autograd.Function` that takes the modules' fp32 parameters, packs
them inside the call, saves the stage-1 output h1 and runs the backward
stage 2 then stage 1.
"""
from __future__ import annotations

import math

import torch

from . import _build
from ..nn import remat as R
from . import spatial_attn as SP
from .spatial_attn import LOG2E, PackedStage, check_packed

T = 16          # sequence length the kernel takes: one 16-row mma tile
# The JAX dispatch keeps C = 1280 in XLA (`_pick_group(5120, 1280, 1) == 0`).
MAX_C = 640
LN2 = math.log(2.0)

launches = 0       # sites whose forward launched kernel 2 (two stage calls each)
bwd_launches = 0   # sites whose backward launched kernel 9 (two stage calls each)


def eligible(shape, dtype, c: int, heads: int) -> bool:
    """Dispatch predicate for tokens of `shape` (N, T, C)."""
    n, t, cc = shape
    return (dtype == torch.bfloat16 and t == T and cc == c == heads * 64
            and (n * t) % 64 == 0 and c <= MAX_C)


def head_order_rows(w, heads: int):
    """The rows of a (3C, ...) matrix in the packing's head order (row 192 h
    + 64 j + i holds row j C + 64 h + i of [q | k | v] order)."""
    c3 = w.shape[0]
    return w.reshape(3, heads, c3 // (3 * heads), *w.shape[1:]).transpose(0, 1).reshape(w.shape)


def qkv_order_rows(w, heads: int):
    """`head_order_rows` undone: head order back to [q | k | v] order."""
    c3 = w.shape[0]
    return w.reshape(heads, 3, c3 // (3 * heads), *w.shape[1:]).transpose(0, 1).reshape(w.shape)


def pack_stage_params(ln_w, ln_b, wq, wk, wv, wo, bo, heads: int) -> PackedStage:
    """Kernel 2's weights of one stage: kernel 1's packing (the softmax scale
    and log2(e) folded into Wq in bf16) with the rows of Wq'|Wk|Wv in head
    order, rows 192 h .. 192 h + 191 = [Wq'_h | Wk_h | Wv_h]."""
    pk = SP.pack_stage_params(ln_w, ln_b, wq, wk, wv, wo, bo, heads)
    return pk._replace(wqkv=head_order_rows(pk.wqkv, heads).contiguous())


@torch.no_grad()
def pack_stage(norm, attn, heads: int) -> PackedStage:
    """norm: LayerNorm module; attn: CrossAttention module (self-attention,
    no q/k/v biases); packed once for inference."""
    out = attn.to_out["0"]
    return pack_stage_params(norm.weight, norm.bias, attn.to_q.weight, attn.to_k.weight,
                             attn.to_v.weight, out.weight, out.bias, heads)


def _bwd_vmem_est(g: int, c: int) -> int:
    blk = 128 * g
    return 2 * 4 * c * c * 2 + 4 * c * c * 4 + blk * c * 44 + 4 * g * 128 * 128 * 4


def bwd_eligible(rows: int, c: int) -> bool:
    """The training dispatch's second predicate: the JAX `bwd_eligible`
    (temporal_attn.py:372-392) arithmetic, copied. It admits the sites where
    the TPU's per-stage backward fits VMEM (C <= 512 at the UNet widths), and
    so decides which temporal sites train through kernels 2 and 9."""
    return any(rows % (128 * g) == 0 and _bwd_vmem_est(g, c) <= 13 * 2**20 for g in (4, 2, 1))


def stage_params(norm, attn):
    """The fp32 parameters of one stage, in the order the ops take them:
    (LN weight, LN bias, Wq, Wk, Wv, Wo, bo), torch (out, in) layouts."""
    out = attn.to_out["0"]
    return (norm.weight, norm.bias, attn.to_q.weight, attn.to_k.weight, attn.to_v.weight,
            out.weight, out.bias)


def plain_stage(x, params, heads: int):
    """LN -> self-attention -> out-projection + bias -> + x in plain torch
    (fp32 LN and softmax islands, products in x's dtype)."""
    from ..nn.attention import plain_attend

    ln_w, ln_b, wq, wk, wv, wo, bo = params
    dt = x.dtype
    xn = torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), ln_w.float(), ln_b.float(),
                                        1e-5).to(dt)
    n, t, c = x.shape
    q, k, v = (torch.nn.functional.linear(xn, w.to(dt)).reshape(n, t, heads, -1)
               for w in (wq, wk, wv))
    o = plain_attend(q, k, v).reshape(n, t, c)
    return torch.nn.functional.linear(o, wo.to(dt), bo.to(dt)) + x


def plain_double_self_attn(tokens, stage1, stage2, heads: int):
    """Reference math: stage(stage(tokens)) with stage = LN -> self-attn -> +x.
    stage1/stage2: (LayerNorm module, CrossAttention module)."""
    return plain_stage(plain_stage(tokens, stage_params(*stage1), heads),
                       stage_params(*stage2), heads)


def _launch_double(tokens, packed):
    """Both kernel-2 stage calls: (out, h1), h1 the stage-1 output."""
    global launches
    n, t, c = tokens.shape
    _build.require(tokens, "tokens")
    for p in packed:
        check_packed(p, c)
    lib = _build.load()
    rows = n * t
    h1 = torch.empty_like(tokens)
    out = torch.empty_like(tokens)
    xn = tokens.new_empty(rows, c)   # LN(x)
    o = tokens.new_empty(rows, c)    # the heads' attention outputs
    P = _build.ptr
    for src, dst, p in ((tokens, h1, packed[0]), (h1, out, packed[1])):
        err = lib.mudg_temporal_attn_stage(
            P(src), P(dst), P(xn), P(o), P(p.ln_w), P(p.ln_b), P(p.wqkv), P(p.wo), P(p.bo),
            rows, c, _build.stream())
        _build.check(err, "temporal_attn")
    launches += 1
    return out, h1


def _check_tokens(tokens, heads, name):
    n, t, c = tokens.shape
    if not eligible(tokens.shape, tokens.dtype, c, heads):
        raise ValueError(f"{name}: unsupported input {tuple(tokens.shape)} "
                         f"{tokens.dtype} with {heads} heads")


def fused_double_self_attn(tokens, stage1, stage2, heads: int,
                           packed: tuple[PackedStage, PackedStage] | None = None):
    """Both LN -> self-attn -> + residual stages over tokens (N, T, C)."""
    if tokens.device.type in ("cpu", "meta"):
        return plain_double_self_attn(tokens, stage1, stage2, heads)
    if packed is None:
        raise RuntimeError("temporal_attn: kernel weights not prepared "
                           "(call mudg_tpu_torch.kernels.prepare_kernels)")
    _check_tokens(tokens, heads, "temporal_attn")
    return _launch_double(tokens, packed)[0]


def plain_temporal_stage_bwd(x, dy, params, heads: int, *, drop_rowsum=False):
    """One stage's gradients in plain torch, the JAX `_bwd_stage_kernel` math
    (fp32, with LN, q'|k|v, the head outputs, dy Wo^T, dS and dq|dk|dv
    rounded to x's dtype where the kernel rounds them): (dx, (dLN w, dLN b,
    dWq, dWk, dWv, dWo, dbo)), weight gradients fp32. `drop_rowsum` plants a
    fault: the softmax Jacobian's row-sum term is left out."""
    ln_w, ln_b, wq, wk, wv, wo, _ = params
    dt = x.dtype
    n, t, c = x.shape
    d = c // heads
    fold = d ** -0.5 * LOG2E

    def r(a):   # round to the working type, compute on in fp32
        return a.to(dt).float()

    xf = x.reshape(-1, c).float()
    mu = xf.mean(-1, keepdim=True)
    inv = torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    xhat = (xf - mu) * inv
    xn = r(xhat * ln_w.float() + ln_b.float())
    wq2 = r(wq.float() * fold)
    wk2, wv2, wo2 = r(wk), r(wv), r(wo)
    q2, k, v = (r(xn @ w.T) for w in (wq2, wk2, wv2))
    dyf = dy.reshape(-1, c).float()
    dyb = r(dyf)
    do_all = r(dyb @ wo2)

    def heads_of(a):
        return a.reshape(n, t, heads, d)

    s = torch.einsum("nqhd,nkhd->nhqk", heads_of(q2), heads_of(k))
    p = torch.softmax(s * LN2, dim=-1)           # base-2 softmax
    pb = r(p)
    o = r(torch.einsum("nhqk,nkhd->nqhd", pb, heads_of(v)).reshape(-1, c))
    dp = torch.einsum("nqhd,nkhd->nhqk", heads_of(do_all), heads_of(v))
    ds = p * dp if drop_rowsum else p * (dp - (p * dp).sum(-1, keepdim=True))
    ds = r(ds * LN2)
    dq = r(torch.einsum("nhqk,nkhd->nqhd", ds, heads_of(k)).reshape(-1, c))
    dk = r(torch.einsum("nhqk,nqhd->nkhd", ds, heads_of(q2)).reshape(-1, c))
    dv = r(torch.einsum("nhqk,nqhd->nkhd", pb, heads_of(do_all)).reshape(-1, c))
    dxn = dq @ wq2 + dk @ wk2 + dv @ wv2
    dxhat = dxn * ln_w.float()
    dx = dyf + inv * (dxhat - dxhat.mean(-1, keepdim=True)
                      - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    grads = ((dxn * xhat).sum(0), dxn.sum(0), (dq.T @ xn) * fold, dk.T @ xn, dv.T @ xn,
             dyb.T @ o, dyf.sum(0))
    return dx.to(dt).reshape(x.shape), grads


def _launch_stage_bwd(x, dy, params, heads):
    """One kernel-9 call: (dx, the seven fp32 gradients of `params`)."""
    n, t, c = x.shape
    rows = n * t
    d = c // heads
    pk = pack_stage_params(*params, heads)
    check_packed(pk, c)
    wqkv_t = pk.wqkv.t().contiguous()
    wo_t = pk.wo.t().contiguous()
    dy = dy.contiguous()
    _build.require(x, "x")
    _build.require(dy, "dy")
    f32 = dict(device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    xn, dout, o = (x.new_empty(rows, c) for _ in range(3))
    dqkv = x.new_empty(rows, 3 * c)
    dxn = torch.empty(rows, c, **f32)
    mean, rstd = torch.empty(rows, **f32), torch.empty(rows, **f32)
    dwqkv, dwo = torch.empty(3 * c, c, **f32), torch.empty(c, c, **f32)
    dlnw, dlnb, dbo = (torch.empty(c, **f32) for _ in range(3))
    work = torch.empty(_build.WORK_ELEMS, **f32)
    P = _build.ptr
    err = _build.load().mudg_temporal_attn_stage_bwd(
        P(x), P(dy), P(dx), P(xn), P(dout), P(o), P(dqkv), P(dxn), P(mean), P(rstd),
        P(pk.ln_w), P(pk.ln_b), P(pk.wqkv), P(wqkv_t), P(wo_t), P(dwqkv), P(dwo), P(dlnw),
        P(dlnb), P(dbo), P(work), _build.WORK_ELEMS, rows, c, _build.stream())
    _build.check(err, "temporal_attn_bwd")
    dwqkv = qkv_order_rows(dwqkv, heads)
    fold = d ** -0.5 * LOG2E
    return dx, (dlnw, dlnb, dwqkv[:c] * fold, dwqkv[c:2 * c], dwqkv[2 * c:], dwo, dbo)


def double_self_attn_bwd(tokens, h1, dy, params1, params2, heads: int):
    """Gradients of both stages for the upstream dy, from the tokens and the
    saved stage-1 output h1: (dx, grads of params1, grads of params2)."""
    global bwd_launches
    if tokens.device.type in ("cpu", "meta"):
        dh1, g2 = plain_temporal_stage_bwd(h1, dy, params2, heads)
        dx, g1 = plain_temporal_stage_bwd(tokens, dh1, params1, heads)
        return dx, g1, g2
    _check_tokens(tokens, heads, "temporal_attn_bwd")
    dh1, g2 = _launch_stage_bwd(h1, dy, params2, heads)
    dx, g1 = _launch_stage_bwd(tokens, dh1, params1, heads)
    bwd_launches += 1
    return dx, g1, g2


class _DoubleSelfAttn(torch.autograd.Function):
    """Kernel 2 forward (with h1 kept), kernel 9 backward per stage (the JAX
    package's `_attach_grad` over `fused_double_self_attn`)."""

    @staticmethod
    def forward(ctx, tokens, heads, *params):
        p1, p2 = params[:7], params[7:]

        def launch():
            if tokens.device.type in ("cpu", "meta"):
                h1 = plain_stage(tokens, p1, heads)
                return plain_stage(h1, p2, heads), h1
            _check_tokens(tokens, heads, "temporal_attn")
            return _launch_double(tokens, (pack_stage_params(*p1, heads),
                                           pack_stage_params(*p2, heads)))

        # y (attn_o, also the block's blk_attn2) and h1 (attn_h1): kept by
        # remat="dots_attn", whose replay then launches no kernel 2
        y, h1 = R.kernel_outputs((("attn_o", "blk_attn2"), ("attn_h1",)), launch)
        ctx.heads = heads
        ctx.save_for_backward(tokens, h1, *params)
        return y

    @staticmethod
    def backward(ctx, dy):
        tokens, h1, *params = ctx.saved_tensors
        dx, g1, g2 = double_self_attn_bwd(tokens, h1, dy, params[:7], params[7:], ctx.heads)
        return (dx, None, *g1, *g2)


def double_self_attn_train(tokens, stage1, stage2, heads: int):
    """Both stages with the gradient to the tokens and to both stages' fp32
    parameters. stage1/stage2: (LayerNorm module, CrossAttention module).
    y and h1 are tagged attn_o / attn_h1 (mudg_tpu/kernels/temporal_attn.py:458-459)."""
    R.tag("attn_o", "attn_h1")
    return _DoubleSelfAttn.apply(tokens, heads, *stage_params(*stage1), *stage_params(*stage2))
