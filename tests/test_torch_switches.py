"""The port's kernel dispatch under the JAX package's six kernel opt-out
switches and in fp32, against traces of the JAX UNet, on the CPU.

- The copied tier predicates (`kernels/spatial_attn.py`: `_pick_bq`,
  `whole_eligible`, `stream_eligible`, `_fb_pick`, `flashblock_eligible`)
  equal the JAX ones (`jax.default_backend` taken as "tpu" inside the test
  only) at every L % 64 == 0 up to 9984 and C in {320, 512, 640, 1280};
  `switched_off` names just the sites the stream / flash-block switches
  take off JAX's kernels.
- Each switch set to "0" alone, and all six: a full-width bf16 UNet forward
  (batch 2, 16 frames) of the port on the meta device calls its kernel
  wrappers exactly as often as `jax.eval_shape` of the JAX `unet_apply`
  calls the JAX kernels (each replaced by a counter that returns its input),
  at MDM512 and MDM1024, and chip_smoke.py's phase-13 table holds those
  counts.
- An fp32 forward with impl="auto": kernel 5 at the JAX trace's flash sites
  (10 at MDM512, 15 at MDM1024) and at no other kernel's, as
  chip_smoke.py's SWITCH_SITES_F32 holds.
- fp32 `plain_flash_attention` and `plain_flash_attention_bwd` (the kernels'
  plain versions) against the Pallas forward and `jax.vjp` of the public op
  in interpret mode: max|diff| <= 2e-5 * max|ref| (fp32 sums in another
  order; tests/test_fused_norms.py's fp32 bound).
"""
from __future__ import annotations

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
import mudg_tpu.kernels.flash_attention as JFA
import mudg_tpu.kernels.mlp as JM
import mudg_tpu.kernels.spatial_attn as JSP
import mudg_tpu.kernels.tconv as JTC
import mudg_tpu.kernels.temporal_attn as JTA
from mudg_tpu.nn import unet3d as JU
from mudg_tpu.apps import render_infer as JR
from mudg_tpu_torch import quant as Q
from mudg_tpu_torch.apps import render_infer as TR
from mudg_tpu_torch.kernels import flash_attention as FA
from mudg_tpu_torch.kernels import spatial_attn as SP
from mudg_tpu_torch.nn import unet3d as TU
from test_torch_util import assert_close, count_kernel_calls, t

F32_REL = 2e-5

# the JAX kernel functions a UNet forward calls, by the port kernel that
# replaces them
JAX_KERNELS = ((JSP, "fused_self_attention", "spatial_attn"),
               (JSP, "stream_self_attention", "spatial_attn"),
               (JSP, "flashblock_self_attention", "spatial_attn"),
               (JTA, "fused_double_self_attn", "temporal_attn"),
               (JM, "fused_geglu_ff", "geglu_ff"), (JM, "fused_geglu_ff_block", "geglu_ff"),
               (JTC, "fused_gn_silu_tconv", "gn_silu_tconv"),
               (JFA, "flash_attention", "flash_attention"))


# the tier of each MuDG spatial self-attention shape (L, C): MDM512 ds1,
# ds2, ds4; MDM1024 ds1, ds2, ds4
MUDG_TIERS = ((2560, 320, "fused"), (640, 640, "fused"), (160, 1280, None),
              (9216, 320, "flashblock"), (2304, 640, "stream"), (576, 1280, None))


@pytest.mark.parametrize("c", [320, 512, 640, 1280])
def test_tier_predicates_match_jax(monkeypatch, c):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    h = c // 64
    for l in range(64, 10000, 64):
        x = jax.ShapeDtypeStruct((2, l, c), jnp.bfloat16)
        shape = (2, l, c)
        assert SP._pick_bq(l, c) == JSP._pick_bq(l, c), l
        assert SP._fb_pick(l, c, h) == JSP._fb_pick(l, c, h), l
        for ours, theirs in ((SP.whole_eligible, JSP.eligible),
                             (SP.stream_eligible, JSP.stream_eligible),
                             (SP.flashblock_eligible, JSP.flashblock_eligible)):
            assert ours(shape, torch.bfloat16, c, h) == theirs(x, c, h), (l, ours.__name__)
            assert not ours(shape, torch.float32, c, h)
    for l, cc, tier in MUDG_TIERS:
        if cc == c:
            assert SP.tier((2, l, c), torch.bfloat16, c, h) == tier, (l, c)


@pytest.mark.parametrize("l,c,off,expect", [
    (9216, 320, ("MUDG_FLASHBLOCK",), True), (9216, 320, ("MUDG_STREAM_SPATIAL",), False),
    (2304, 640, ("MUDG_STREAM_SPATIAL",), False),   # falls to the flash-block tier
    (2304, 640, ("MUDG_STREAM_SPATIAL", "MUDG_FLASHBLOCK"), True),
    (2560, 320, ("MUDG_STREAM_SPATIAL", "MUDG_FLASHBLOCK"), False),   # whole-block tier
    (64, 64, ("MUDG_STREAM_SPATIAL", "MUDG_FLASHBLOCK"), False)])   # no JAX tier: kernel 1 keeps it
def test_switched_off_names_only_the_sites_jax_sends_away(monkeypatch, l, c, off, expect):
    for var in CS.OPT_OUT:
        monkeypatch.delenv(var, raising=False)
    assert not SP.switched_off((2, l, c), torch.bfloat16, c, c // 64)
    for var in off:
        monkeypatch.setenv(var, "0")
    assert SP.switched_off((2, l, c), torch.bfloat16, c, c // 64) == expect


def _jax_calls(monkeypatch, dtype, latent, quantize="none"):
    """Calls of each JAX kernel (by port name) in `jax.eval_shape` of one
    full-width JAX UNet forward at batch 2, 16 frames; its tree quantized
    as the JAX app's `prepare_serving_params` does for `quantize`."""
    calls = collections.Counter()
    for mod, fn, name in JAX_KERNELS:
        def fake(*a, _name=name, **k):
            calls[_name] += 1
            return a[0]
        monkeypatch.setattr(mod, fn, fake)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cfg = JU.UNetConfig()
    params = jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), cfg))
    if quantize != "none":
        params = jax.eval_shape(lambda p: JR.prepare_serving_params(
            {"unet": p}, quantize, None)["unet"], params)
    S = jax.ShapeDtypeStruct
    h, w = latent
    jax.eval_shape(lambda p, x, ts, c, lab: JU.unet_apply(p, cfg, x, ts, c, c_label=lab), params,
                   S((2, 16, h, w, 12), dtype), S((2,), jnp.int32),
                   S((2, 77 + 256, 1024), dtype), S((2,), jnp.int32))
    return {k: v for k, v in calls.items() if v}


def _port_calls(monkeypatch, dtype, latent, quantize="none"):
    """Calls of each port kernel wrapper in one full-width UNet forward
    (batch 2, 16 frames, impl="auto") on the meta device; quantized as
    `render --quantize` quantizes it."""
    calls = count_kernel_calls(monkeypatch)
    h, w = latent
    with torch.device("meta"), torch.no_grad():
        unet = TU.UNet3D(TU.UNetConfig())
        if quantize != "none":
            Q.quantize_module(unet, **TR.quantize_options(quantize))
        unet.to(dtype)
        x = torch.empty(2, 16, h, w, 12, dtype=dtype)
        ctx = torch.empty(2, 77 + 256, 1024, dtype=dtype)
        ts = torch.zeros(2, dtype=torch.int64)
        assert unet(x, ts, ctx, c_label=ts).shape == (2, 16, h, w, 4)
    return {k: v for k, v in calls.items() if v}


@pytest.mark.parametrize("switch", [*CS.OPT_OUT, "all"])
@pytest.mark.parametrize("config", ["mdm512", "mdm1024"])
def test_opt_out_sites_match_jax_trace(monkeypatch, config, switch):
    """With `switch` (or all six) set to "0", the port's wrappers run where
    the traced JAX UNet runs its kernels, at chip_smoke.py's phase-13
    counts; with none set, at SITES."""
    for var in CS.OPT_OUT:
        monkeypatch.delenv(var, raising=False)
    cases = {name: (env, expect) for name, env, expect in CS.opt_out_cases(config)}
    env, expect = cases[switch]
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    latent = CS.LATENT[config]
    with monkeypatch.context() as mp:
        theirs = _jax_calls(mp, jnp.bfloat16, latent)
    ours = _port_calls(monkeypatch, torch.bfloat16, latent)
    assert ours == theirs == {k: v for k, v in expect.items() if v}
    assert ours != {k: v for k, v in CS.SITES[config].items() if v} or switch in (
        "MUDG_STREAM_SPATIAL", "MUDG_FLASHBLOCK")


@pytest.mark.parametrize("config", ["mdm512", "mdm1024"])
def test_f32_forward_flash_sites_match_jax_trace(monkeypatch, config):
    """An fp32 forward with impl="auto" runs kernel 5 (fp32) at the JAX
    trace's flash sites, at every spatial self-attention with L >= 512, and
    no other of kernels 1-5: SWITCH_SITES_F32's flash count."""
    for var in CS.OPT_OUT:
        monkeypatch.delenv(var, raising=False)
    latent = CS.LATENT[config]
    with monkeypatch.context() as mp:
        theirs = _jax_calls(mp, jnp.float32, latent)
    ours = _port_calls(monkeypatch, torch.float32, latent)
    flash = CS.SWITCH_SITES_F32[config]["flash_attention"]
    assert ours == theirs == {"flash_attention": flash}
    assert flash == {"mdm512": 10, "mdm1024": 15}[config]


@pytest.mark.parametrize("quantize", CS.QUANTIZE_MODES)
def test_quantized_sites_match_jax_trace(monkeypatch, quantize):
    """Under each --quantize mode, a full-width bf16 MDM512 forward (batch
    2) calls the port's kernel wrappers where the traced JAX UNet, its tree
    quantized by the JAX app, calls its kernels (an int8 layer's site takes
    the XLA path, kernel 5 still applies): chip_smoke.py's QUANT_SITES."""
    for var in CS.OPT_OUT:
        monkeypatch.delenv(var, raising=False)
    latent = CS.LATENT["mdm512"]
    with monkeypatch.context() as mp:
        theirs = _jax_calls(mp, jnp.bfloat16, latent, quantize)
    ours = _port_calls(monkeypatch, torch.bfloat16, latent, quantize)
    expect = {**CS.SITES["mdm512"], **CS.QUANT_SITES[quantize]}
    assert ours == theirs == {k: v for k, v in expect.items() if v}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape", [(2, 192, 3, 64), (1, 640, 2, 64)])
def test_f32_plain_flash_matches_pallas(shape):
    """Kernel 5's plain version in fp32 against the Pallas forward (the
    public op and the raw kernel's lse) in interpret mode; L = 192 and 640
    leave 64 rows past a multiple of 128."""
    q, k, v, _ = _qkv(shape, 31)
    o, lse = FA.plain_flash_attention(t(q), t(k), t(v))
    assert o.dtype == lse.dtype == torch.float32
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = np.asarray(JFA.flash_attention(jq, jk, jv))
    _, lse_ref = JFA._flash_fwd(*JFA._fold(jq, jk, jv))
    assert ref.dtype == np.float32
    assert_close(o, ref, F32_REL, 0.0, "o")
    assert_close(lse, np.asarray(lse_ref)[..., 0], F32_REL, 0.0, "lse")


@pytest.mark.parametrize("shape", [(2, 192, 3, 64), (1, 640, 2, 64)])
def test_f32_plain_flash_bwd_matches_jax_vjp(shape):
    """Kernel 6's plain version in fp32, from the port's own o and lse,
    against `jax.vjp` of the JAX public op (its Pallas backward kernels in
    interpret mode)."""
    q, k, v, do = _qkv(shape, 32)
    o, lse = FA.plain_flash_attention(t(q), t(k), t(v))
    got = FA.plain_flash_attention_bwd(t(q), t(k), t(v), o, lse, t(do))
    _, vjp = jax.vjp(JFA.flash_attention, *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        assert_close(g, np.asarray(r), F32_REL, 0.0, name)
