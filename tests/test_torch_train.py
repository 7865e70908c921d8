"""PyTorch port vs JAX for MDM training: the plain versions of the backward
kernels 6, 9 and 10 against the Pallas backward bodies (interpret mode) and
against autodiff of the XLA math, the port's autograd ops against the same;
the stage-2 mask and the learning-rate schedules; remat, dropout and the
training ops' reading of the current weights; and the `impl="train"`
dispatch sites of a full-width MDM512 and MDM1024 UNet, forward and
backward, against the JAX predicates. `training_loss` and the train step
are held against JAX in tests/test_torch_train_loss.py and
tests/test_torch_train_step.py.

Tolerances: atol 2e-4 for the flash backward (tests/test_attention.py:94-95);
5e-2 * max|ref| per gradient where a bf16 Pallas kernel is the reference
(tests/test_attention.py:274-280); 1e-4 * max|ref| where both sides are the
same fp32 math.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mudg_tpu.kernels import flash_attention as JFA
from mudg_tpu.kernels import mlp as JM
from mudg_tpu.kernels import temporal_attn as JTA
from mudg_tpu.models import mdm as JMDM
from mudg_tpu.models import presets as JP
from mudg_tpu.nn import attention as JA
from mudg_tpu.nn import unet3d as JU
from mudg_tpu.train import step as JS
from mudg_tpu_torch import convert
from mudg_tpu_torch.kernels import flash_attention as FA
from mudg_tpu_torch.kernels import mlp as M
from mudg_tpu_torch.kernels import temporal_attn as TA
from mudg_tpu_torch.models import presets as TP
from mudg_tpu_torch.nn import attention as TAT
from mudg_tpu_torch.nn import unet3d as TU
from mudg_tpu_torch.train import step as TS
from test_torch_util import assert_close, port, random_tree, t, to_jax

F32 = np.float32
S = jax.ShapeDtypeStruct
KTOL = 5e-2           # a gradient against a bf16 Pallas kernel
SAME = 1e-4           # the same fp32 math on both sides


def _ln_tree(c, seed):
    return random_tree({"weight": S((c,), jnp.float32), "bias": S((c,), jnp.float32)}, seed)


# ---------------------------------------------------------------------------
# Kernel 6: the FlashAttention-2 backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body", ["whole", "chunked"])
def test_flash_bwd_matches_pallas_bwd(body):
    """`plain_flash_attention_bwd` from the port's own o and lse against the
    Pallas dQ and dK/dV bodies: whole-L (`_flash_bwd`) and the long-L chunked
    ones (`_flash_bwd_chunked`, 64-row tiles), (1, 128, 2, 64) fp32."""
    rng = np.random.default_rng(50)
    q, k, v, do = (rng.standard_normal((1, 128, 2, 64)).astype(F32) for _ in range(4))
    qf, kf, vf, dof = (JFA._fold(jnp.asarray(a), jnp.asarray(a), jnp.asarray(a))[0]
                       for a in (q, k, v, do))
    o, lse = JFA._flash_fwd(qf, kf, vf)
    if body == "whole":
        ref = JFA._flash_bwd(qf, kf, vf, o, lse, dof)
    else:
        delta = jnp.sum(o * dof, axis=-1, keepdims=True)
        ref = JFA._flash_bwd_chunked(qf, kf, vf, lse, delta, dof, 64, 64)
    ours_o, ours_lse = FA.flash_attention(t(q), t(k), t(v))
    got = FA.plain_flash_attention_bwd(t(q), t(k), t(v), ours_o, ours_lse, t(do))
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert g.shape == q.shape and g.dtype == torch.float32
        assert_close(g, JFA._unfold(r, q.shape), 0.0, 2e-4, name)


def test_flash_train_op_matches_jax_grad():
    """The autograd op (`flash_attention_train`; on the CPU its plain forward
    and backward) against jax.vjp of the XLA attention, and its forward
    against the plain attention."""
    rng = np.random.default_rng(51)
    q, k, v, do = (rng.standard_normal((2, 64, 3, 64)).astype(F32) for _ in range(4))
    o_ref, vjp = jax.vjp(lambda a, b, c: JA.attend(a, b, c, impl="xla"),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    qt, kt, vt = (t(a).requires_grad_() for a in (q, k, v))
    o = FA.flash_attention_train(qt, kt, vt)
    assert_close(o, o_ref, SAME, 0.0, "o")
    for g, r, name in zip(torch.autograd.grad(o, (qt, kt, vt), t(do)), ref, ("dq", "dk", "dv")):
        assert_close(g, r, 0.0, 2e-4, name)


# ---------------------------------------------------------------------------
# Kernel 9: one temporal stage's backward
# ---------------------------------------------------------------------------

C_T, HEADS_T, N_T = 128, 2, 8      # rows N*T = 128: one grid step of the Pallas body


def _temporal_stage(seed):
    """A stage's JAX parameter dict and the port's (norm, attention) modules."""
    key = jax.random.PRNGKey(0)
    attn = random_tree(jax.eval_shape(
        lambda: JA.init_cross_attention(key, C_T, heads=HEADS_T, dim_head=64)), seed)
    norm = _ln_tree(C_T, seed + 1)
    mods = (port(nn.LayerNorm(C_T), norm),
            port(TAT.CrossAttention(C_T, heads=HEADS_T, dim_head=64), attn))
    return {"norm": to_jax(norm), **to_jax(attn)}, mods


def _stage_grads_torch_layout(g):
    """The JAX per-stage gradient dict in `stage_params` order, torch layouts."""
    out = g["to_out"]["0"]
    return (g["norm"]["weight"], g["norm"]["bias"], g["to_q"]["weight"].T,
            g["to_k"]["weight"].T, g["to_v"]["weight"].T, out["weight"].T, out["bias"])


def test_temporal_stage_bwd_matches_pallas_bwd():
    """`plain_temporal_stage_bwd` against the Pallas `_bwd_one_stage` on the
    same bf16 tokens and upstream gradient with fp32 parameters: dx and the
    gradients of LN w/b, Wq (scale * log2(e) unfolded), Wk, Wv, Wo and bo."""
    p, mods = _temporal_stage(60)
    rng = np.random.default_rng(61)
    x, dy = (rng.standard_normal((N_T, 16, C_T)).astype(F32) for _ in range(2))
    xb, dyb = (jnp.asarray(a, jnp.bfloat16) for a in (x, dy))
    dx_ref, g_ref = JTA._bwd_one_stage(xb.reshape(-1, C_T), dyb.reshape(-1, C_T), p, C_T,
                                       HEADS_T, 16)
    to_bf = lambda a: t(np.asarray(a.astype(jnp.float32))).bfloat16()   # noqa: E731
    dx, grads = TA.plain_temporal_stage_bwd(to_bf(xb), to_bf(dyb), TA.stage_params(*mods),
                                            HEADS_T)
    assert dx.dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in grads)
    assert_close(dx.reshape(-1, C_T), dx_ref.astype(jnp.float32), KTOL, 0.0, "dx")
    names = ("dLN w", "dLN b", "dWq", "dWk", "dWv", "dWo", "dbo")
    for g, r, name in zip(grads, _stage_grads_torch_layout(g_ref), names):
        assert_close(g, r, KTOL, 0.0, name)


def test_temporal_train_op_matches_jax_grad():
    """The autograd op over both stages (`double_self_attn_train`; on the
    CPU the plain stages and `plain_temporal_stage_bwd`, which walks stage 2
    on the saved h1 and then stage 1) against jax.vjp of the XLA double
    stage in fp32: the tokens' and all fourteen parameters' gradients."""
    p1, (n1, a1) = _temporal_stage(62)
    p2, (n2, a2) = _temporal_stage(64)
    rng = np.random.default_rng(66)
    x, dy = (rng.standard_normal((N_T, 16, C_T)).astype(F32) for _ in range(2))
    y_ref, vjp = jax.vjp(lambda a, b, c: JTA._xla_impl(a, b, c, t=16, heads=HEADS_T),
                         jnp.asarray(x), p1, p2)
    dx_ref, g1_ref, g2_ref = vjp(jnp.asarray(dy))
    xt = t(x).requires_grad_()
    params = [*TA.stage_params(n1, a1), *TA.stage_params(n2, a2)]
    y = TA.double_self_attn_train(xt, (n1, a1), (n2, a2), HEADS_T)
    assert_close(y, y_ref, SAME, 0.0, "y")
    got = torch.autograd.grad(y, [xt, *params], t(dy))
    refs = [dx_ref, *_stage_grads_torch_layout(g1_ref), *_stage_grads_torch_layout(g2_ref)]
    for i, (g, r) in enumerate(zip(got, refs)):
        assert_close(g, r, SAME, 1e-6, f"gradient {i}")


# ---------------------------------------------------------------------------
# Kernel 10: the GEGLU feed-forward backward
# ---------------------------------------------------------------------------

M_F, C_F = 256, 32      # inner 128: one (256, 128) block of the Pallas body


def _ff(seed):
    key = jax.random.PRNGKey(0)
    tree = random_tree(jax.eval_shape(lambda: JA.init_feed_forward(key, C_F)), seed)
    return tree, port(TAT.FeedForward(C_F), tree)


def test_ff_bwd_matches_pallas_bwd():
    """`plain_geglu_ff_bwd` against the Pallas `_ff_bwd_apply` in fp32 (the
    same math: u, g, the erf GELU and its derivative with the normal pdf):
    dx, dW1 (value | gate), db1, dW2, db2."""
    tree, ff = _ff(70)
    rng = np.random.default_rng(71)
    x, dy = (rng.standard_normal((M_F, C_F)).astype(F32) for _ in range(2))
    jt = to_jax(tree)
    ref = JM._ff_bwd_apply(jnp.asarray(x), jnp.asarray(dy), jt["net"]["0"]["proj"]["weight"],
                           jt["net"]["0"]["proj"]["bias"], jt["net"]["2"]["weight"])
    w1, b1, w2, _ = M.ff_params(ff)
    got = M.plain_geglu_ff_bwd(t(x), t(dy), w1, b1, w2)
    refs = (ref[0], ref[1].T, ref[2], ref[3].T, ref[4])
    for g, r, name in zip(got, refs, ("dx", "dW1", "db1", "dW2", "db2")):
        assert g.dtype == torch.float32
        assert_close(g, r, SAME, 0.0, name)


@pytest.mark.parametrize("block", [False, True])
def test_ff_train_ops_match_jax_grad(block):
    """The autograd ops (`geglu_ff_train`, and `geglu_ff_block_train` whose
    backward recomputes the LN and takes its and the residual's backward in
    torch) against jax.vjp of the JAX FF math, gradients to x and every
    parameter."""
    tree, ff = _ff(72)
    ln = _ln_tree(C_F, 73)
    norm = port(nn.LayerNorm(C_F), ln)
    rng = np.random.default_rng(74)
    x, dy = (rng.standard_normal((2, M_F // 2, C_F)).astype(F32) for _ in range(2))
    jt, jl = to_jax(tree), to_jax(ln)
    proj, out = jt["net"]["0"]["proj"], jt["net"]["2"]
    operands = (jnp.asarray(x), proj["weight"], proj["bias"], out["weight"], out["bias"])
    if block:
        fn = lambda a, lw, lb, *w: JM._ff_block_math(a, lw, lb, *w)   # noqa: E731
        operands = operands[:1] + (jl["weight"], jl["bias"]) + operands[1:]
    else:
        fn = JM._ff_math
    y_ref, vjp = jax.vjp(fn, *operands)
    refs = list(vjp(jnp.asarray(dy)))
    w_at = 3 if block else 1          # the JAX (in, out) weights -> torch (out, in)
    refs[w_at], refs[w_at + 2] = refs[w_at].T, refs[w_at + 2].T
    xt = t(x).requires_grad_()
    params = ([norm.weight, norm.bias] if block else []) + list(M.ff_params(ff))
    y = M.geglu_ff_block_train(xt, norm, ff) if block else M.geglu_ff_train(xt, ff)
    assert_close(y, y_ref, SAME, 0.0, "y")
    for i, (g, r) in enumerate(zip(torch.autograd.grad(y, [xt, *params], t(dy)), refs)):
        assert_close(g, r, SAME, 1e-6, f"gradient {i}")


# ---------------------------------------------------------------------------
# The stage-2 mask and the learning-rate schedules
# ---------------------------------------------------------------------------

def test_temporal_frozen_mask_and_schedules_match_jax():
    """The port's stage-2 mask marks the same leaves as the JAX mask, and
    each learning-rate schedule gives optax's value at every update count."""
    cfg = JP.tiny()
    tree = random_tree(jax.eval_shape(lambda: JMDM.init_mdm(jax.random.PRNGKey(0), cfg)), 80)
    jmask = JS.temporal_frozen_mask(cfg.unet, tree["unet"])
    as_arrays = jax.tree.map(lambda m, p: np.full(p.shape, m, F32), jmask, tree["unet"])
    ref = {k: bool(v.reshape(-1)[0]) for k, v in convert.tree_to_state_dict(as_arrays).items()}
    ours = TS.temporal_frozen_mask(TU.UNet3D(TP.tiny().unet))
    assert ours == ref and 0 < sum(ours.values()) < len(ours)
    for sched in (None, "lambda_warmup", "cosine"):
        kw = dict(scheduler=sched, warmup_steps=3, decay_steps=5, min_lr_ratio=0.1)
        jfn = JS.make_lr_schedule(JS.TrainConfig(**kw), 2e-4)
        tfn = TS.make_lr_schedule(TS.TrainConfig(**kw), 2e-4)
        for count in range(8):
            ref_lr = float(jfn(count)) if callable(jfn) else jfn
            assert math.isclose(tfn(count), ref_lr, rel_tol=1e-6), (sched, count)


# ---------------------------------------------------------------------------
# remat, dropout, current weights
# ---------------------------------------------------------------------------

def _tiny_unet_inputs(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    u = cfg.unet
    x = torch.randn(2, u.temporal_length, 8, 8, u.in_channels, generator=g)
    ctx = torch.randn(2, 77 + u.temporal_length * u.image_tokens_per_frame, u.context_dim,
                      generator=g)
    return x, torch.tensor([10, 900]), ctx, torch.tensor([0, 500])


@pytest.mark.parametrize("remat", [True, "full", "dots", "dots_small", "dots_ln", "dots_attn",
                                   "except_ff", "dots_gn", "convs", "names"])
def test_remat_gives_the_same_grads(remat):
    """The UNet with remat=True (every input, middle and output block under
    torch.utils.checkpoint) or a selective policy (nn/remat.py) gives the
    gradients of remat=False, dropout on: each block draws its masks from a
    generator of its own, so the recompute draws them again. An unknown
    policy raises."""
    cfg = TP.tiny()
    assert cfg.unet.dropout > 0
    unet = TU.UNet3D(cfg.unet)
    tree = random_tree(jax.eval_shape(
        lambda: JU.init_unet(jax.random.PRNGKey(0), JP.tiny().unet)), 95)
    unet = port(unet, tree)
    x, ts, ctx, lab = _tiny_unet_inputs(cfg, 96)
    grads = []
    for r in (False, remat):
        unet.zero_grad(set_to_none=True)
        y = unet(x, ts, ctx, c_label=lab, impl="train", remat=r,
                 generator=torch.Generator().manual_seed(7))
        (y ** 2).sum().backward()
        grads.append({n: p.grad.clone() for n, p in unet.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5, atol=1e-6, msg=n)
    with pytest.raises(ValueError):
        unet(x, ts, ctx, c_label=lab, remat="dots_everything")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keep_rate_and_scale(dtype):
    """Inverted dropout at rate 0.1 keeps 0.9 of 10^6 elements within five
    standard deviations (1.5e-3) and scales each kept one by 1 / 0.9 in its
    dtype; the generator decides the mask."""
    n = 10**6
    x = torch.ones(n, dtype=dtype)
    y = TU.dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert y.dtype == dtype
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) <= 5 * math.sqrt(0.9 * 0.1 / n)
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.9))
    assert torch.equal(y, TU.dropout(x, 0.1, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, TU.dropout(x, 0.1, torch.Generator().manual_seed(1)))


def test_training_forward_reads_the_current_weights(monkeypatch):
    """A bf16 transformer block at kernel-site shapes (L = 512 flash
    self-attention, the LN + FF block) under impl="train": after its kernel
    packs are made and two weights change, the training forward follows the
    changed weights, through the training ops, and equals the plain path."""
    import mudg_tpu_torch.kernels as K

    taken = []
    for mod, name in ((FA, "flash_attention_train"), (M, "geglu_ff_block_train")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name: taken.append(_n) or _o(*a))
    g = torch.Generator().manual_seed(97)
    blk = TAT.BasicTransformerBlock(128, heads=2, dim_head=64)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[-1]))
    x = torch.randn(1, 512, 128, generator=g).bfloat16()
    K.prepare_kernels(blk)
    y0 = blk(x, None, impl="train")
    with torch.no_grad():
        blk.ff.net["2"].weight.mul_(2.0)
        blk.attn1.to_v.weight.mul_(-1.0)
    y1 = blk(x, None, impl="train")
    # attn1 and attn2 (no context: self-attention too) at L = 512, the FF block
    assert taken == (["flash_attention_train"] * 2 + ["geglu_ff_block_train"]) * 2
    assert (y1.float() - y0.float()).abs().max().item() > 0.1
    assert torch.equal(y1, blk(x, None, impl="plain"))


# ---------------------------------------------------------------------------
# impl="train" dispatch sites at full width
# ---------------------------------------------------------------------------

# per training forward at batch 1 x 16 frames: flash, temporal, FF sites; the
# MDM512 middle block's two FFs (m = 5 x 8 x 16 = 640 rows) fail m % 256 in
# both predicates
TRAIN_SITES = {"mdm512": ((40, 64), {"flash": 10, "temporal": 6, "ff": 31}),
               "mdm1024": ((72, 128), {"flash": 15, "temporal": 6, "ff": 33})}


@pytest.mark.parametrize("config", ["mdm512", "mdm1024"])
def test_train_dispatch_sites_match_jax_predicates(monkeypatch, config):
    """One full-width UNet training forward and backward (batch 1, 16
    frames, fp32 parameters, bf16 activations, remat) traced on the meta
    device. Every attention, FF and temporal-transformer call of the forward
    is put to the JAX training predicates on its shapes (the TPU backend
    check taken as true): the sites they admit are exactly the ones that
    reached the training ops. The backward launches each backward op once
    per site; the recompute runs the forward ops again, except at
    init_attn, which is not checkpointed."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    (h, w), expect = TRAIN_SITES[config]
    phase = ["fwd"]
    calls = {"fwd": {}, "bwd": {}}
    jax_admits = {"flash": 0, "temporal": 0, "ff": 0}
    bf = jnp.bfloat16

    def count(mod, name, key):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            calls[phase[0]][key] = calls[phase[0]].get(key, 0) + 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    def record(mod, name, judge):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            if phase[0] == "fwd":
                jax_admits[judge[0]] += bool(judge[1](*a, **k))
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for mod, name, key in ((FA, "flash_attention_train", "flash"),
                           (TA, "double_self_attn_train", "temporal"),
                           (M, "geglu_ff_train", "ff"), (M, "geglu_ff_block_train", "ff"),
                           (FA, "flash_attention_bwd", "flash_bwd"),
                           (TA, "double_self_attn_bwd", "temporal_bwd"),
                           (M, "geglu_ff_bwd", "ff_bwd")):
        count(mod, name, key)

    def jax_flash(q, k, v, *, causal=False, impl="auto"):
        # JAX attend: no bias, not causal, equal lengths, L % 64, D % 64, L >= 512
        return (not causal and q.shape[1] == k.shape[1] and q.shape[1] % 64 == 0
                and q.shape[-1] % 64 == 0 and q.shape[1] >= JA.FLASH_MIN_SEQ)

    def jax_ff(x, inner):
        c = x.shape[-1]
        return (JM.geglu_ff_eligible(S(tuple(x.shape), bf), S((c, 2 * inner), bf))
                and JM.ff_bwd_eligible(x.numel() // c, c, inner))

    def jax_ff_bare(ff, x, impl="auto", packed=None):
        return jax_ff(x, ff.net["2"].in_features)

    def jax_ff_block(ff, norm, x, impl="auto", packed=None):
        # an ineligible block falls back to feed_forward, judged there
        return x.shape[-1] < 640 and jax_ff(x, ff.net["2"].in_features)

    def jax_temporal(self, x, context=None, *, causal=False, temporal_length=None,
                     impl="auto", sp=None):
        b, tt, hh, ww, _ = x.shape
        c = self.proj_in.weight.shape[0]     # the tokens' width after proj_in
        tokens = S((b * hh * ww, tt, c), bf)
        return (context is None and not causal and JTA.eligible(tokens, c, self.heads, tt)
                and JTA.bwd_eligible(b * hh * ww * tt, c))

    record(TAT, "attend", ("flash", jax_flash))
    record(TAT, "feed_forward", ("ff", jax_ff_bare))
    record(TAT, "feed_forward_block", ("ff", jax_ff_block))
    record(TAT.TemporalTransformer, "forward", ("temporal", jax_temporal))

    bft = torch.bfloat16
    with torch.device("meta"):
        unet = TU.UNet3D(TU.UNetConfig())
        x = torch.empty(1, 16, h, w, 12, dtype=bft)
        ctx = torch.empty(1, 77 + 256, 1024, dtype=bft)
        ts = torch.zeros(1, dtype=torch.int64)
        y = unet(x, ts, ctx, c_label=ts, impl="train", remat=True)
        assert y.shape == (1, 16, h, w, 4)
        phase[0] = "bwd"
        y.float().sum().backward()
    assert jax_admits == expect
    assert calls["fwd"] == expect
    init_attn = {"flash": 0, "temporal": 1, "ff": 1}
    assert calls["bwd"] == {**{k + "_bwd": v for k, v in expect.items()},
                            **{k: v - init_attn[k] for k, v in expect.items()}}
