"""The UNet's remat policies (`nn/remat.py`) against the JAX package's, on the
CPU.

- Every policy, and remat=True, gives remat=False's gradients of every UNet
  parameter at the tiny config in fp32 with dropout on: max|diff| <= 1e-5 *
  max|ref| per leaf (a policy changes what is kept, never what is computed).
- The tags of each checkpointed block's forward (the port's tag sites and
  kernel ops) equal the `checkpoint_name` primitives inside each `jax.checkpoint`
  of a `jax.make_jaxpr` trace of the JAX `unet_apply` (trace only): at the
  tiny config in fp32, with and without MUDG_FUSED_NORMS=1 (JAX's TPU check
  taken as true inside the test), and at full MDM512 width in bf16 on the
  training dispatch, where kernels 2, 3 and 5 carry their tags.
- The kernel forwards each policy's backward replay runs again (kernels 5,
  2 and 3 at a batch-1 MDM512 micro-step) equal those in the JAX gradient's
  jaxpr (each JAX kernel forward wrapped in a named jit to count it) and
  chip_smoke.py's REPLAYED table; the port's are its plain versions' calls
  in the backward of a meta-device run. Under dots_attn the replay calls
  no plain flash or temporal forward.
- The keep mode saves the ops of a kept site: in a real
  CPU backward, no convolution reruns where conv_out is kept and no
  native_layer_norm where ln_out is.
"""
from __future__ import annotations

import collections
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as CS
import mudg_tpu.kernels.flash_attention as JFA
import mudg_tpu.kernels.mlp as JM
import mudg_tpu.kernels.temporal_attn as JTA
import mudg_tpu.nn.functional as JF
from mudg_tpu.models import presets as JP
from mudg_tpu.nn import unet3d as JU
from mudg_tpu_torch.kernels import flash_attention as FA
from mudg_tpu_torch.kernels import mlp as M
from mudg_tpu_torch.kernels import temporal_attn as TA
from mudg_tpu_torch.models import presets as TP
from mudg_tpu_torch.nn import functional as TF
from mudg_tpu_torch.nn import remat as R
from mudg_tpu_torch.nn import unet3d as TU
from test_torch_util import port, random_tree

S = jax.ShapeDtypeStruct
POLICIES = list(R.POLICIES)
REL = 1e-5


def _tiny_unet():
    tree = random_tree(jax.eval_shape(
        lambda: JU.init_unet(jax.random.PRNGKey(0), JP.tiny().unet)), 95)
    return port(TU.UNet3D(TP.tiny().unet), tree)


def _tiny_inputs(u, seed=96):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, u.temporal_length, 8, 8, u.in_channels, generator=g)
    ctx = torch.randn(2, 77 + u.temporal_length * u.image_tokens_per_frame, u.context_dim,
                      generator=g)
    return x, torch.tensor([10, 900]), ctx, torch.tensor([0, 500])


@pytest.fixture(scope="module")
def tiny():
    unet = _tiny_unet()
    args = _tiny_inputs(unet.cfg)

    def grads(remat):
        unet.zero_grad(set_to_none=True)
        x, ts, ctx, lab = args
        y = unet(x, ts, ctx, c_label=lab, impl="train", remat=remat,
                 generator=torch.Generator().manual_seed(7))
        (y ** 2).sum().backward()
        return {n: p.grad.clone() for n, p in unet.named_parameters()}

    return unet, args, grads, grads(False)


@pytest.mark.parametrize("policy", [True, *POLICIES])
def test_policy_gradients_match_no_remat(tiny, policy):
    assert tiny[0].cfg.dropout > 0
    ref = tiny[3]
    got = tiny[2](policy)
    assert sorted(got) == sorted(ref)
    for n, g in ref.items():
        diff = (got[n] - g).abs().max().item()
        assert diff <= REL * g.abs().max().item(), (n, diff)


def test_unknown_policy_raises(tiny):
    unet, (x, ts, ctx, lab), _, _ = tiny
    with pytest.raises(ValueError, match="unknown remat policy"):
        unet(x, ts, ctx, c_label=lab, remat="dots_everything")


def _jax_block_tags(jaxpr):
    """Counter of `checkpoint_name` tags inside each remat eqn, in order."""
    blocks = []

    def count(j, c):
        for e in j.eqns:
            if e.primitive.name == "name":
                c[e.params["name"]] += 1
            for sub in _subjaxprs(e):
                count(sub, c)

    def walk(j):
        for e in j.eqns:
            if e.primitive.name in ("remat2", "checkpoint"):
                c = collections.Counter()
                count(e.params["jaxpr"], c)
                blocks.append(c)
            else:
                for sub in _subjaxprs(e):
                    walk(sub)

    walk(jaxpr)
    return blocks


def _subjaxprs(e):
    for v in e.params.values():
        for sub in (v if isinstance(v, (list, tuple)) else [v]):
            if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                yield sub.jaxpr
            elif hasattr(sub, "eqns"):
                yield sub


def _port_block_tags(unet, x, ts, ctx, lab):
    with R.record() as rec:
        unet(x, ts, ctx, c_label=lab, impl="train", remat="names")
    return [collections.Counter(dict(c)) for c in rec]


@pytest.mark.parametrize("fused_norms", [False, True])
def test_tags_per_block_match_jax_tiny(tiny, monkeypatch, fused_norms):
    """Tiny config, fp32: every block's tags (mm_out, conv_out, tconv_out,
    gn_out, ln_out, ff_inner, blk_*); with MUDG_FUSED_NORMS=1 the GroupNorms
    that kernel 11 fits keep gn_out and its LayerNorms drop ln_out, as
    JAX's fused-norm paths do."""
    if fused_norms:
        monkeypatch.setattr(JF, "_use_fused_norms", lambda: True)
        monkeypatch.setattr(TF, "_fused_norms", lambda x: True)
    unet, (x, ts, ctx, lab), _, _ = tiny
    cfg = JP.tiny().unet
    params = jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), cfg))
    jx = jax.make_jaxpr(lambda p, *a: JU.unet_apply(p, cfg, *a[:3], c_label=a[3], impl="train",
                                                    remat="names"))(
        params, *(S(tuple(v.shape), jnp.float32 if v.is_floating_point() else jnp.int32)
                  for v in (x, ts, ctx, lab)))
    ref = _jax_block_tags(jx.jaxpr)
    with torch.no_grad():
        ours = _port_block_tags(unet, x, ts, ctx, lab)
    assert ours == ref
    total = sum(ref, collections.Counter())
    # half the tiny config's LayerNorms fit kernel 11, whose tag goes
    assert total["gn_out"] == 56 and total["ln_out"] == (12 if fused_norms else 24)


def test_tags_per_block_match_jax_mdm512(monkeypatch):
    """Full MDM512 width, bf16, the training dispatch (batch 1, 16 frames):
    the kernel sites' tags too (attn_o/attn_lse of kernel 5, attn_o/attn_h1
    of kernel 2, blk_ff of kernel 3's block form), the port on the meta
    device."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cfg = JU.UNetConfig()
    params = jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), cfg))
    h, w = CS.LATENT["mdm512"]
    jx = jax.make_jaxpr(lambda p, x, t, c, l: JU.unet_apply(
        p, cfg, x, t, c, c_label=l, impl="train", remat="names"))(
        params, S((1, 16, h, w, 12), jnp.bfloat16), S((1,), jnp.int32),
        S((1, 77 + 256, 1024), jnp.bfloat16), S((1,), jnp.int32))
    ref = _jax_block_tags(jx.jaxpr)
    bf = torch.bfloat16
    with torch.device("meta"), torch.no_grad():
        unet = TU.UNet3D(TU.UNetConfig())
        t = torch.zeros(1, dtype=torch.int64)
        ours = _port_block_tags(unet, torch.empty(1, 16, h, w, 12, dtype=bf), t,
                                torch.empty(1, 77 + 256, 1024, dtype=bf), t)
    assert ours == ref
    total = sum(ref, collections.Counter())
    assert total["attn_lse"] == CS.TRAIN_SITES["mdm512"]["flash_attention"]
    assert total["attn_h1"] == (CS.TRAIN_SITES["mdm512"]["temporal_attn"]
                                - CS.INIT_ATTN_SITES["temporal_attn"])


def _named(mod, fn, name, static=()):
    """mod.fn wrapped in a jit named `name`, so the gradient's jaxpr shows
    each of its calls as one eqn."""
    orig = getattr(mod, fn)

    def f(*a, **k):
        return orig(*a, **k)

    f.__name__ = name
    return jax.jit(f, static_argnames=static)


def _jax_kernel_forwards(monkeypatch, remat):
    """Kernel 5, 2 and 3 forwards in the jaxpr of the gradient of one
    MDM512 UNet forward (batch 1, 16 frames, bf16, impl="train")."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for mod, fn, name, static in ((JFA, "_flash_fwd", "k_flash_attention", ()),
                                  (JTA, "_fused_impl", "k_temporal_attn", ("t", "heads")),
                                  (JM, "_ff_apply", "k_geglu_ff", ()),
                                  (JM, "_ff_block_apply", "k_geglu_ff", ())):
        monkeypatch.setattr(mod, fn, _named(mod, fn, name, static))
    cfg = JU.UNetConfig()
    params = jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), cfg))
    h, w = CS.LATENT["mdm512"]

    def loss(p, x, t, c, l):
        return JU.unet_apply(p, cfg, x, t, c, c_label=l, impl="train",
                             remat=remat).astype(jnp.float32).sum()

    jx = jax.make_jaxpr(jax.grad(loss))(
        params, S((1, 16, h, w, 12), jnp.bfloat16), S((1,), jnp.int32),
        S((1, 77 + 256, 1024), jnp.bfloat16), S((1,), jnp.int32))
    calls = collections.Counter()

    def walk(j):
        for e in j.eqns:
            name = e.params.get("name", "")
            if e.primitive.name in ("jit", "pjit") and str(name).startswith("k_"):
                calls[name[2:]] += 1
                continue
            for sub in _subjaxprs(e):
                walk(sub)

    walk(jx.jaxpr)
    return dict(calls)


def _port_kernel_forwards(monkeypatch, remat):
    """(forward, backward) calls of kernels 5, 2 and 3's plain forwards in
    one MDM512 UNet forward and its backward on the meta device."""
    phase = ["fwd"]
    calls = {"fwd": collections.Counter(), "bwd": collections.Counter()}

    def count(mod, fn, key, per):
        orig = getattr(mod, fn)

        def wrapped(*a, **k):
            calls[phase[0]][key] += per
            return orig(*a, **k)

        monkeypatch.setattr(mod, fn, wrapped)

    count(FA, "flash_attention", "flash_attention", 1)
    count(TA, "plain_stage", "temporal_attn", 0.5)   # two stages a site
    count(M, "_plain_ff", "geglu_ff", 1)
    h, w = CS.LATENT["mdm512"]
    bf = torch.bfloat16
    with torch.device("meta"):
        unet = TU.UNet3D(TU.UNetConfig())
        t = torch.zeros(1, dtype=torch.int64)
        y = unet(torch.empty(1, 16, h, w, 12, dtype=bf), t,
                 torch.empty(1, 77 + 256, 1024, dtype=bf), c_label=t, impl="train", remat=remat)
        phase[0] = "bwd"
        y.float().sum().backward()
    return {k: {n: int(v) for n, v in c.items()} for k, c in calls.items()}


@pytest.mark.parametrize("policy", [False, *POLICIES])
def test_replayed_kernel_forwards_match_table(monkeypatch, policy):
    """Kernel 5, 2 and 3 forwards of one MDM512 micro-step under `policy`
    (forward and the backward's replay) are chip_smoke.py's
    policy_launches, which REPLAYED makes from TRAIN_SITES."""
    ours = _port_kernel_forwards(monkeypatch, policy)
    sites = CS.TRAIN_SITES["mdm512"]
    assert ours["fwd"] == sites
    expect = CS.policy_launches("mdm512", policy)
    assert {k: ours["fwd"][k] + ours["bwd"].get(k, 0) for k in sites} == {
        k: expect[k] for k in sites}


# one policy of each kind: every kernel replayed, kernels 5 and 2 only, none
@pytest.mark.parametrize("policy", ["dots", "names", "dots_attn"])
def test_replayed_kernel_forwards_match_jax(monkeypatch, policy):
    """The JAX gradient's jaxpr keeps the kernel forwards that REPLAYED
    lists (`python tests/test_torch_remat.py` prints all ten policies')."""
    ref = _jax_kernel_forwards(monkeypatch, policy)
    expect = CS.policy_launches("mdm512", policy)
    assert ref == {k: expect[k] for k in CS.TRAIN_SITES["mdm512"]}


def _ops_checkpointed(policy):
    """A small checkpointed block with kernel 5's and kernel 2's training
    ops (their plain versions on the CPU), fp32: its gradient under
    `policy`, and the plain forwards called in the backward."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 128, 2, 64, generator=g, requires_grad=True) for _ in range(3))
    tok = torch.randn(8, 16, 64, generator=g, requires_grad=True)
    stages = []
    with torch.random.fork_rng():
        torch.manual_seed(4)
        for _ in range(2):
            stages.append((torch.nn.LayerNorm(64), TU.A.CrossAttention(64, heads=1, dim_head=64)))

    def fn(q, k, v, tok):
        return FA.flash_attention_train(q, k, v).sum() + TA.double_self_attn_train(
            tok, *stages, 1).square().sum()

    calls = collections.Counter()

    def counted(name, orig):
        @functools.wraps(orig)
        def w(*a, **kw):
            calls[name] += 1
            return orig(*a, **kw)
        return w

    out = (R.checkpoint(fn, q, k, v, tok, remat=policy) if policy is not False
           else fn(q, k, v, tok))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FA, "plain_flash_attention", counted("flash", FA.plain_flash_attention))
        mp.setattr(TA, "plain_stage", counted("stage", TA.plain_stage))
        out.backward()
    return [t.grad for t in (q, k, v, tok)], dict(calls)


def test_dots_attn_replay_calls_no_plain_forward():
    """The backward of a checkpointed block: under dots_attn no plain flash
    or temporal forward is called (their outputs come from the block's
    stash), under full recompute one of each (two temporal stages), and the
    gradients are remat=False's."""
    ref, none = _ops_checkpointed(False)
    assert none == {}
    for policy, want in (("dots_attn", {}), ("full", {"flash": 1, "stage": 2}),
                         ("names", {"flash": 1, "stage": 2})):
        got, calls = _ops_checkpointed(policy)
        assert calls == want, policy
        for a, b in zip(got, ref):
            assert torch.equal(a, b), policy


def _backward_ops(unet, args, remat):
    """ATen forward ops (by packet) the backward runs, i.e. the replay's."""
    x, ts, ctx, lab = args
    unet.zero_grad(set_to_none=True)
    y = unet(x, ts, ctx, c_label=lab, impl="train", remat=remat)
    seen = collections.Counter()

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            seen[func.overloadpacket.__name__] += 1
            return func(*a, **(kw or {}))

    with Count():
        (y ** 2).sum().backward()
    return seen


@pytest.mark.parametrize("policy", ["full", "convs", "dots_small", "dots_ln", "names"])
def test_kept_sites_do_not_rerun(tiny, policy):
    """No convolution reruns in the backward where conv_out is kept, no
    native_layer_norm where ln_out is, and both rerun under full recompute."""
    unet, args, _, _ = tiny
    base = _backward_ops(unet, args, False)
    seen = _backward_ops(unet, args, True if policy == "full" else policy)
    keeps = R.POLICIES[policy] or ()
    for op, tag in (("convolution", "conv_out"), ("native_layer_norm", "ln_out")):
        replayed = seen[op] - base[op]
        assert (replayed == 0) == (tag in keeps), (op, replayed)


if __name__ == "__main__":
    # the JAX gradient's kernel forwards under every policy (~20-30 s each)
    jax.config.update("jax_platforms", "cpu")
    for remat in (False, True, *POLICIES[1:]):
        with pytest.MonkeyPatch.context() as mp:
            print(remat, _jax_kernel_forwards(mp, remat), flush=True)
