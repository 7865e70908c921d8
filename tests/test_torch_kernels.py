"""PyTorch port vs JAX for each module that holds a kernel
(mudg_tpu_torch.kernels.{spatial_attn, temporal_attn, mlp, tconv}).

On the CPU a kernel wrapper runs its plain version, which is held
  * against the JAX XLA math (`_xla_impl`, `_xla_math`, `_ff_block_math`,
    `_ff_math`) in fp32: max|diff| <= 1e-4 * max|ref| + 1e-6;
  * against the JAX Pallas kernel in interpret mode, at the JAX tests'
    shapes: max|diff| <= 3e-2 * max|ref| (the kernels compute in bf16).
The packed kernel weights are checked by redoing the CUDA kernels' algebra
with them in torch (folded softmax scale, [value | gate] rows, 3-tap
(C, 3C) conv weight). The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py and chip_smoke.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mudg_tpu.kernels import mlp as JM
from mudg_tpu.kernels import spatial_attn as JSP
from mudg_tpu.kernels import tconv as JTC
from mudg_tpu.kernels import temporal_attn as JTA
from mudg_tpu.nn import attention as JA
from mudg_tpu_torch.kernels import mlp as M
from mudg_tpu_torch.kernels import spatial_attn as SP
from mudg_tpu_torch.kernels import tconv as TC
from mudg_tpu_torch.kernels import temporal_attn as TA
from mudg_tpu_torch.nn import attention as A
from mudg_tpu_torch.nn import functional as F
from test_torch_util import assert_close, port, random_tree, t, to_jax

XLA_TOL, KERNEL_TOL = 1e-4, 3e-2
SDS = jax.ShapeDtypeStruct


def _norm_tree(c, seed):
    return random_tree({"weight": SDS((c,), jnp.float32), "bias": SDS((c,), jnp.float32)}, seed)


def _attn(c, heads, seed):
    shapes = jax.eval_shape(lambda: JA.init_cross_attention(
        jax.random.PRNGKey(0), c, heads=heads, dim_head=c // heads))
    tree = random_tree(shapes, seed)
    return tree, port(A.CrossAttention(c, heads=heads, dim_head=c // heads), tree)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------- spatial attn

@pytest.mark.parametrize("heads,c,l", [(2, 128, 128), (3, 192, 256)])
def test_spatial_plain_matches_xla(heads, c, l):
    p_attn, attn = _attn(c, heads, 0)
    p_norm = _norm_tree(c, 1)
    norm = port(nn.LayerNorm(c), p_norm)
    x = _x((2, l, c), 2)
    ref = JSP._xla_impl(jnp.asarray(x), to_jax(p_norm), to_jax(p_attn), heads=heads)
    with torch.no_grad():
        ours = SP.fused_self_attention(t(x), norm, attn, heads)
    assert_close(ours, ref, XLA_TOL, 1e-6)


def test_spatial_plain_matches_pallas_interpret():
    heads, c, l = 2, 128, 128
    p_attn, attn = _attn(c, heads, 3)
    p_norm = _norm_tree(c, 4)
    norm = port(nn.LayerNorm(c), p_norm)
    x = _x((2, l, c), 5)
    ref = JSP._fused_impl(jnp.asarray(x), to_jax(p_norm), to_jax(p_attn), heads=heads)
    with torch.no_grad():
        ours = SP.fused_self_attention(t(x), norm, attn, heads)
    assert_close(ours, ref, KERNEL_TOL)


def _kernel_algebra_stage(x, packed, heads, seq):
    """The CUDA stage's math with its packed weights, in fp32 torch: LN from
    row stats, one q|k|v product with the folded scale, base-2 softmax over
    each `seq`-row sequence, out-projection + bias + residual."""
    n, c = x.shape
    mu = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    xn = (x - mu) * rstd * packed.ln_w + packed.ln_b
    qkv = xn @ packed.wqkv.float().T
    q, k, v = (qkv[:, i * c:(i + 1) * c].reshape(n // seq, seq, heads, -1) for i in range(3))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdim=True), v).reshape(n, c)
    return x + o @ packed.wo.float().T + packed.bo


def test_spatial_packed_weights_reproduce_plain():
    heads, c, l = 2, 128, 64
    _, attn = _attn(c, heads, 6)
    norm = port(nn.LayerNorm(c), _norm_tree(c, 7))
    packed = SP.pack_stage(norm, attn, heads)
    assert packed.wqkv.dtype == torch.bfloat16 and packed.wqkv.shape == (3 * c, c)
    x = t(_x((2, l, c), 8))
    with torch.no_grad():
        ref = SP.plain_self_attention(x, norm, attn, heads)
        ours = _kernel_algebra_stage(x.reshape(-1, c), packed, heads, l).reshape(x.shape)
    assert_close(ours, ref, KERNEL_TOL)


# -------------------------------------------------------------- temporal attn

def _temporal_params(c, heads, seed):
    shapes = jax.eval_shape(lambda: JA.init_transformer_block(
        jax.random.PRNGKey(0), c, heads=heads, dim_head=64))
    pb = random_tree(shapes, seed)
    p1 = {"norm": pb["norm1"], **pb["attn1"]}
    p2 = {"norm": pb["norm2"], **pb["attn2"]}
    blk = port(A.BasicTransformerBlock(c, heads=heads, dim_head=64), pb)
    return p1, p2, blk


@pytest.mark.parametrize("heads,c,n", [(2, 128, 8), (1, 64, 4)])
def test_temporal_plain_matches_xla(heads, c, n):
    p1, p2, blk = _temporal_params(c, heads, 10)
    x = _x((n, 16, c), 11)
    ref = JTA._xla_impl(jnp.asarray(x), to_jax(p1), to_jax(p2), t=16, heads=heads)
    with torch.no_grad():
        ours = TA.fused_double_self_attn(t(x), (blk.norm1, blk.attn1), (blk.norm2, blk.attn2), heads)
    assert_close(ours, ref, XLA_TOL, 1e-6)


def test_temporal_plain_matches_pallas_interpret():
    heads, c, n = 2, 128, 64   # rows = 1024: the group-8 double kernel
    p1, p2, blk = _temporal_params(c, heads, 12)
    x = _x((n, 16, c), 13)
    ref, _ = JTA._fused_impl(jnp.asarray(x), to_jax(p1), to_jax(p2), t=16, heads=heads)
    with torch.no_grad():
        ours = TA.fused_double_self_attn(t(x), (blk.norm1, blk.attn1), (blk.norm2, blk.attn2), heads)
    assert_close(ours, ref, KERNEL_TOL)


def test_temporal_packed_weights_reproduce_plain():
    heads, c, n = 2, 128, 8
    _, _, blk = _temporal_params(c, heads, 14)
    blk.pack_kernel_weights()
    x = t(_x((n, 16, c), 15))
    with torch.no_grad():
        ref = TA.plain_double_self_attn(x, (blk.norm1, blk.attn1), (blk.norm2, blk.attn2), heads)
        h = x.reshape(-1, c)
        for name in ("attn1", "attn2"):
            h = _kernel_algebra_stage(h, blk.kernel_packs[name], heads, 16)
    assert_close(h.reshape(x.shape), ref, KERNEL_TOL)


# ------------------------------------------------------------------ GEGLU FF

def _ff(c, seed):
    shapes = jax.eval_shape(lambda: JA.init_feed_forward(jax.random.PRNGKey(0), c))
    tree = random_tree(shapes, seed)
    p_norm = _norm_tree(c, seed + 1)
    w = (p_norm["weight"], p_norm["bias"], tree["net"]["0"]["proj"]["weight"],
         tree["net"]["0"]["proj"]["bias"], tree["net"]["2"]["weight"], tree["net"]["2"]["bias"])
    return [jnp.asarray(a) for a in w], port(A.FeedForward(c), tree), port(nn.LayerNorm(c), p_norm)


@pytest.mark.parametrize("block", [True, False])
def test_ff_plain_matches_xla(block):
    c = 64
    (lnw, lnb, w1, b1, w2, b2), ff, norm = _ff(c, 20)
    x = _x((2, 128, c), 21)
    with torch.no_grad():
        if block:
            ref = JM._ff_block_math(jnp.asarray(x), lnw, lnb, w1, b1, w2, b2)
            ours = M.fused_geglu_ff_block(t(x), norm, ff)
        else:
            ref = JM._ff_math(jnp.asarray(x), w1, b1, w2, b2)
            ours = M.fused_geglu_ff(t(x), ff)
    assert_close(ours, ref, XLA_TOL, 1e-6)


@pytest.mark.parametrize("block", [True, False])
def test_ff_plain_matches_pallas_interpret(block):
    c = 64   # tests/test_kernel_dispatch.py:78-86 shape
    (lnw, lnb, w1, b1, w2, b2), ff, norm = _ff(c, 22)
    x = _x((2, 256, c), 23)
    with torch.no_grad():
        if block:
            ref = JM.fused_geglu_ff_block(jnp.asarray(x), lnw, lnb, w1, b1, w2, b2)
            ours = M.fused_geglu_ff_block(t(x), norm, ff)
        else:
            ref = JM.fused_geglu_ff(jnp.asarray(x), w1, b1, w2, b2)
            ours = M.fused_geglu_ff(t(x), ff)
    assert_close(ours, ref, KERNEL_TOL)


def test_ff_packed_weights_reproduce_plain():
    c = 64
    _, ff, norm = _ff(c, 24)
    packed = M.pack_ff(ff, norm)
    inner = packed.w2.shape[1]
    x = t(_x((256, c), 25))
    with torch.no_grad():
        ref = M.plain_geglu_ff_block(x, norm, ff)
        xn = F.layer_norm(norm, x)
        ug = xn @ packed.w1.float().T + packed.b1
        u, g = ug[:, :inner], ug[:, inner:]
        h = u * g * 0.5 * (1 + torch.erf(g * 2 ** -0.5))
        ours = h @ packed.w2.float().T + packed.b2 + x
    assert_close(ours, ref, KERNEL_TOL)


# ------------------------------------------------------ GN + SiLU + tconv

def _tconv(c, seed):
    rng = np.random.default_rng(seed)
    p_gn = {"weight": (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32),
            "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}
    p_conv = {"weight": (rng.standard_normal((3, 1, 1, c, c)) * 0.05).astype(np.float32),
              "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}
    return p_gn, p_conv, port(nn.GroupNorm(32, c), p_gn), port(nn.Conv3d(c, c, (3, 1, 1)), p_conv)


def test_tconv_plain_matches_xla():
    p_gn, p_conv, norm, conv = _tconv(64, 30)
    x = _x((2, 4, 8, 16, 64), 31)
    ref = JTC._xla_math(jnp.asarray(x), to_jax(p_gn), to_jax(p_conv))
    with torch.no_grad():
        ours = TC.fused_gn_silu_tconv(t(x), norm, conv)
    assert_close(ours, ref, XLA_TOL, 1e-6)


def test_tconv_plain_matches_pallas_interpret():
    p_gn, p_conv, norm, conv = _tconv(64, 32)   # tests/test_kernel_dispatch.py:104-110
    xb = jnp.asarray(_x((1, 4, 8, 16, 64), 33)).astype(jnp.bfloat16)
    ref = JTC.fused_gn_silu_tconv(xb, to_jax(p_gn), to_jax(p_conv))
    with torch.no_grad():
        ours = TC.fused_gn_silu_tconv(t(np.asarray(xb, np.float32)), norm, conv)
    assert_close(ours, np.asarray(ref, np.float32), KERNEL_TOL)


def test_tconv_gn_fold_and_packed_weights():
    """gn_fold matches the JAX fold, and the kernel's implicit GEMM with the
    packed (C, 3C) weight, [x_{t-1} | x_t | x_{t+1}] with zero rows at the t
    edges, reproduces the plain stage."""
    c = 64
    p_gn, p_conv, norm, conv = _tconv(c, 34)
    x = t(_x((2, 4, 8, 8, c), 35) * 3 + 1)
    ref_sc, ref_sh = JTC.gn_fold(to_jax(p_gn), jnp.asarray(x.numpy()))
    scale, shift = TC.gn_fold(norm, x)
    assert_close(scale, ref_sc, XLA_TOL, 1e-6)
    assert_close(shift, ref_sh, XLA_TOL, 1e-6)
    packed = TC.pack_tconv(conv, norm)
    with torch.no_grad():
        a = x * scale[:, None, None, None] + shift[:, None, None, None]
        a = a * torch.sigmoid(a)
        zero = torch.zeros_like(a[:, :1])
        cat = torch.cat([torch.cat([zero, a[:, :-1]], 1), a,
                         torch.cat([a[:, 1:], zero], 1)], dim=-1)
        ours = cat @ packed.wcat.float().T + packed.bias
        ref = TC.plain_gn_silu_tconv(x, norm, conv)
    assert_close(ours, ref, KERNEL_TOL)


def test_wrappers_refuse_unprepared_cuda_weights():
    """A wrapper never falls back from a non-CPU tensor to the plain path:
    without packed weights it raises before touching the device."""
    class Fake:
        device = torch.device("cuda")

    with pytest.raises(RuntimeError, match="not prepared"):
        SP.fused_self_attention(Fake(), None, None, 2)
    with pytest.raises(RuntimeError, match="not prepared"):
        TC.fused_gn_silu_tconv(Fake(), None, None)
