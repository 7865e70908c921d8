"""The algebra of kernels 2 and 10's Hopper designs, in plain torch on the CPU,
held against the JAX package.

Kernel 2 (`csrc/temporal_attn.cu`) runs per stage: LN to bf16, then one GEMM
whose tile is 64 rows (four 16-row sequences) by the 192 rows of one head
of the packed weight, [Wq'_h | Wk_h | Wv_h] (`temporal_attn.pack_stage`), with
the attention as its epilogue: q, k, v rounded to bf16, the base-2 softmax
over each sequence normalised and rounded to bf16, o_h = P v rounded to bf16
at column 64 h; then x + o Wo^T + bo. `_temporal_steps` walks those tiles in
that order; it is held against `mudg_tpu.kernels.temporal_attn`'s XLA path
at 192 rows (the last 64-row tile alone in its 128-row block) and against
the Pallas `fused_double_self_attn` in interpret mode at 128 rows. A packing
with k_h and k_{h+1} swapped must miss the tolerance.

Kernel 10 (`csrc/mlp_bwd.cu`) computes u | g and dh per 64-row tile, h and
[du | dg] in bf16 and each tile's fp32 column sums of du and dg (db1 adds
them in tile order), dx = [du | dg] W1, and the weight gradients as sums
over contiguous row splits added in split order. `_ff_bwd_steps` is that
algebra; it is held against the Pallas `_ff_bwd_apply` in interpret mode,
and dW1 written transposed (a kernel storing its output tile the wrong way
round) must miss.

Tolerance: max|diff| <= 3e-2 * max|ref| for kernel 2 (on the output less the
residual), 5e-2 * max|ref| for each of kernel 10's gradients, as the JAX
kernel tests (tests/test_attention.py:262,274-280).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudg_tpu.kernels import mlp as JM
from mudg_tpu.kernels import temporal_attn as JTA
from mudg_tpu.nn import attention as JA
from mudg_tpu_torch.kernels import mlp as M
from mudg_tpu_torch.kernels import spatial_attn as SP
from mudg_tpu_torch.kernels import temporal_attn as TA
from mudg_tpu_torch.nn import attention as A
from test_torch_kernels import _temporal_params, _x
from test_torch_util import assert_close, port, random_tree, t, to_jax

KERNEL_TOL = 3e-2
BWD_TOL = 5e-2


def _bf16(v):
    return v.to(torch.bfloat16).float()


# ------------------------------------------------------------------ kernel 2

def _temporal_stage_steps(x, pk, heads):
    """One stage of kernel 2 on x (rows, C), bf16 values in fp32, tile by
    tile: 64-row tiles, and in each the 192 packed rows of one head."""
    rows, c = x.shape
    mu = x.mean(-1, keepdim=True)
    xn = _bf16((x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
               * pk.ln_w + pk.ln_b)
    w = pk.wqkv.float()
    o = torch.empty_like(x)
    for m0 in range(0, rows, 64):
        for h in range(heads):
            qkv = _bf16(xn[m0:m0 + 64] @ w[192 * h:192 * (h + 1)].T)   # (64, 192)
            q, k, v = (qkv[:, 64 * i:64 * (i + 1)].reshape(4, 16, 64) for i in range(3))
            s = q @ k.transpose(1, 2)                                  # four sequences
            p = torch.exp2(s - s.amax(-1, keepdim=True))
            p = _bf16(p / p.sum(-1, keepdim=True))
            o[m0:m0 + 64, 64 * h:64 * (h + 1)] = _bf16(p @ v).reshape(64, 64)
    return _bf16(x + o @ pk.wo.float().T + pk.bo)


def _temporal_steps(x, packs, heads):
    """Both stages on tokens x (N, 16, C)."""
    h = x.reshape(-1, x.shape[-1])
    for pk in packs:
        h = _temporal_stage_steps(h, pk, heads)
    return h.reshape(x.shape)


def _swap_k_heads(pk, h):
    """The packing with head h's key rows and head h + 1's swapped."""
    w = pk.wqkv.clone()
    a, b = slice(192 * h + 64, 192 * h + 128), slice(192 * (h + 1) + 64, 192 * (h + 1) + 128)
    w[a], w[b] = pk.wqkv[b], pk.wqkv[a]
    return pk._replace(wqkv=w)


def _temporal_case(c, heads, n, seed):
    p1, p2, blk = _temporal_params(c, heads, seed)
    xb = jnp.asarray(_x((n, 16, c), seed + 1)).astype(jnp.bfloat16)
    x = t(np.asarray(xb, np.float32))
    packs = [TA.pack_stage(blk.norm1, blk.attn1, heads), TA.pack_stage(blk.norm2, blk.attn2, heads)]
    return p1, p2, xb, x, packs


def test_temporal_packing_is_head_ordered():
    """Rows 192 h .. 192 h + 191 of the packed weight are [Wq'_h | Wk_h |
    Wv_h] of kernel 1's packing; a TemporalTransformer's blocks pack so."""
    c, heads = 128, 2
    _, _, blk = _temporal_params(c, heads, 30)
    pk, sp = TA.pack_stage(blk.norm1, blk.attn1, heads), SP.pack_stage(blk.norm1, blk.attn1, heads)
    for h in range(heads):
        for i in range(3):   # q', k, v
            assert torch.equal(pk.wqkv[192 * h + 64 * i:192 * h + 64 * (i + 1)],
                               sp.wqkv[c * i + 64 * h:c * i + 64 * (h + 1)])
    assert torch.equal(pk.wo, sp.wo) and torch.equal(pk.bo, sp.bo)
    tt = A.TemporalTransformer(c, heads=heads, dim_head=64)
    for blk in tt.transformer_blocks.values():
        blk.pack_kernel_weights()
        ref = TA.pack_stage(blk.norm1, blk.attn1, heads)
        assert torch.equal(blk.kernel_packs["attn1"].wqkv, ref.wqkv)


def test_temporal_steps_match_xla_and_see_mispacked_heads():
    """192 rows: the third 64-row tile is the only one in its 128-row block."""
    c, heads, n = 128, 2, 12
    p1, p2, xb, x, packs = _temporal_case(c, heads, n, 31)
    ref = np.asarray(JTA._xla_impl(xb.astype(jnp.float32), to_jax(p1), to_jax(p2), t=16,
                                   heads=heads), np.float32)
    with torch.no_grad():
        ours = _temporal_steps(x, packs, heads)
        assert_close(ours - x, ref - x.numpy(), KERNEL_TOL)
        wrong = _temporal_steps(x, [_swap_k_heads(pk, 0) for pk in packs], heads)
    with pytest.raises(AssertionError):
        assert_close(wrong - x, ref - x.numpy(), KERNEL_TOL)


def test_temporal_steps_match_pallas_interpret():
    c, heads, n = 128, 2, 8   # 128 rows: the Pallas kernel takes rows % 128 == 0
    p1, p2, xb, x, packs = _temporal_case(c, heads, n, 33)
    ref, _ = JTA._fused_impl(xb, to_jax(p1), to_jax(p2), t=16, heads=heads)
    with torch.no_grad():
        ours = _temporal_steps(x, packs, heads)
    assert_close(ours - x, np.asarray(ref, np.float32) - x.numpy(), KERNEL_TOL)


# ----------------------------------------------------------------- kernel 10

def _ff_bwd_steps(x, dy, w1, b1, w2, splits):
    """Kernel 10's algebra on x, dy (M, C) bf16 values in fp32: (dx, dW1, db1,
    dW2, db2) with torch's W1 (2 inner, C), W2 (C, inner)."""
    m, c = x.shape
    inner = w2.shape[1]
    w1b, w2t = _bf16(w1), _bf16(w2).T
    # 1. per 64-row tile: u | g = x W1^T + b1, dh = dy (W2^T)^T, the GEGLU
    #    backward, h and [du | dg] in bf16, the fp32 column sums of du, dg
    ug = x @ w1b.T + b1
    u, g = ug[:, :inner], ug[:, inner:]
    dh = dy @ w2t.T
    phi = 0.5 * (1 + torch.erf(g * 2 ** -0.5))
    h = _bf16(u * g * phi)
    du = dh * g * phi
    dg = dh * u * (phi + g * torch.exp(-0.5 * g * g) * 0.3989422804014327)
    dudg = _bf16(torch.cat([du, dg], -1))
    part = torch.cat([du, dg], -1).reshape(-1, 64, 2 * inner).sum(1)
    db1 = torch.zeros(2 * inner)
    for row in part:   # tile order
        db1 = db1 + row
    # 2. dx = [du | dg] W1
    dx = _bf16(dudg @ w1b)

    # 3. weight gradients over contiguous row splits, added in split order
    def wgrad(a, b):
        out = torch.zeros(a.shape[1], b.shape[1])
        for rows in torch.arange(m).chunk(splits):
            out = out + a[rows].T @ b[rows]
        return out

    return dx, wgrad(dudg, x), db1, wgrad(dy, h), dy.sum(0)


def test_ff_bwd_steps_match_pallas_interpret():
    """m = 256 rows in 3 splits; C = 64, inner = 256 (a single Pallas grid
    step). dW1 transposed misses."""
    tree = random_tree(jax.eval_shape(lambda: JA.init_feed_forward(jax.random.PRNGKey(0), 64)),
                       80)
    ff = port(A.FeedForward(64), tree)
    rng = np.random.default_rng(81)
    xb, dyb = (jnp.asarray(rng.standard_normal((256, 64)).astype(np.float32)).astype(jnp.bfloat16)
               for _ in range(2))
    jt = to_jax(tree)
    ref = JM._ff_bwd_apply(xb, dyb, jt["net"]["0"]["proj"]["weight"],
                           jt["net"]["0"]["proj"]["bias"], jt["net"]["2"]["weight"])
    refs = [torch.tensor(np.asarray(r, np.float32)) for r in (ref[0], ref[1].T, ref[2], ref[3].T,
                                                              ref[4])]
    w1, b1, w2, _ = (p.detach() for p in M.ff_params(ff))
    x, dy = (t(np.asarray(v, np.float32)) for v in (xb, dyb))
    got = _ff_bwd_steps(x, dy, w1, b1, w2, splits=3)
    for g, r, name in zip(got, refs, ("dx", "dW1", "db1", "dW2", "db2")):
        err = (g - r).abs().max().item()
        assert err <= BWD_TOL * r.abs().max().item(), (name, err)
    dw1 = got[1]
    wrong = dw1.T.contiguous().reshape(dw1.shape)   # the (M, N) tile stored as (N, M)
    assert (wrong - refs[1]).abs().max().item() > BWD_TOL * refs[1].abs().max().item()
