"""The UNet and sampler options that no MuDG config sets, the port against
JAX on the CPU in fp32.

- Relative-position attention with and without the causal mask, the joint
  task attention (num_tasks task-major chunks), and the cross-context
  temporal path (temporal_selfatt_only=False): each option's transformer
  and the two option UNets that chip_smoke.py's phase 19 (d) runs (all
  three of the first together, the cross-context one alone: JAX refuses it
  beside relative position), at a tiny config, after converting random
  weights; the ValueErrors JAX raises (a batch the tasks do not divide,
  h*w that T does not divide).
- Their parameters: every leaf of `jax.eval_shape(init_unet)` at full width
  has a port parameter of its torch layout, and a MuDG `.ckpt` carrying the
  new leaves imports and loads strictly.
- Their kernel sites at full width: a `jax.eval_shape` trace of the JAX UNet
  (each kernel replaced by a counter) against the port's forward on the
  meta device and chip_smoke.py's OPTION_SITES.
- The masked DDIM and DPM-Solver++ loops, `stochastic_encode` and the full
  ancestral `ddpm_sample` (v, eps and x0, with and without clip_denoised)
  with JAX's draws passed in.

The JAX references run under jax.jit: one compile of the tiny UNet takes
4-8 s where its ops one by one take 26-32 s.

Tolerance: tests/test_reference_oracle.py:46-53, 2e-3 * max|ref| + 5e-5;
the masked loops and stochastic_encode (a few fp32 steps) also within 1e-5
relative. `ddpm_sample`'s 1000 steps are held to the oracle's tolerance
alone: XLA's and torch's fp32 tanh and exp differ by an ulp, and with
clip_denoised eps's 1e10 terminal coefficient spreads that (1.6e-5 relative
seen).
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
from mudg_tpu.core import schedules as JS
from mudg_tpu.diffusion import ddim as JDDIM
from mudg_tpu.diffusion import dpm as JDPM
from mudg_tpu.nn import attention as JA
from mudg_tpu.nn import unet3d as JU
from mudg_tpu.train.checkpoint import pytree_to_state_dict
from mudg_tpu_torch import convert
from mudg_tpu_torch.core import schedules as TS
from mudg_tpu_torch.diffusion import ddim as TDDIM
from mudg_tpu_torch.diffusion import dpm as TDPM
from mudg_tpu_torch.nn import attention as TA
from mudg_tpu_torch.nn import unet3d as TU
from mudg_tpu_torch.train import checkpoint as TC
from test_torch_util import assert_close, count_kernel_calls, port, random_tree, t, to_jax

TOL, ATOL = 2e-3, 5e-5
SAMPLER_TOL = 1e-5
T_, L_ = 4, 4   # frames; temporal_length
TINY = dict(in_channels=12, out_channels=4, model_channels=32, num_res_blocks=1,
            attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=16,
            context_dim=16, temporal_length=L_, image_tokens_per_frame=16, dropout=0.0)
# chip_smoke.py phase 19 (d)'s two UNets: the options JAX takes together
OPTIONS = {name: dict(kw) for name, kw in CS.OPTION_UNETS.items()}


def _ctx(rng, b, d=16):
    return rng.standard_normal((b, 77 + T_ * 16, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# each option's transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_relative_position_temporal_transformer(causal):
    """A temporal transformer with relative-position tables, causal or not
    (init_attn's use is the non-causal one): JAX's dense relative branch."""
    key = jax.random.PRNGKey(0)
    tree = random_tree(jax.eval_shape(lambda: JA.init_temporal_transformer(
        key, 32, heads=2, dim_head=16, relative_position=True, temporal_length=L_)), 3)
    x = np.random.default_rng(4).standard_normal((2, T_, 4, 4, 32)).astype(np.float32)
    ref = jax.jit(lambda p, x: JA.temporal_transformer(p, x, None, heads=2, causal=causal,
                                                       temporal_length=L_))(
        to_jax(tree), jnp.asarray(x))
    m = port(TA.TemporalTransformer(32, heads=2, dim_head=16, relative_position=True,
                                    temporal_length=L_), tree)
    with torch.no_grad():
        ours = m(t(x), causal=causal, temporal_length=L_)
    assert_close(ours, ref, TOL, ATOL, f"rel-pos causal={causal}")


def test_relative_position_bias_clips():
    table = np.arange(9 * 2, dtype=np.float32).reshape(9, 2)
    ours = TA.relative_position_bias(torch.from_numpy(table), 6, 7, 4)
    ref = JA.relative_position_bias(jnp.asarray(table), 6, 7, 4)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("batch", [3, 6])
def test_joint_task_spatial_transformer(batch):
    """A spatial transformer with the joint task attention (three tasks;
    one or two samples a task, so the within-chunk index matters)."""
    key = jax.random.PRNGKey(0)
    tree = random_tree(jax.eval_shape(lambda: JA.init_spatial_transformer(
        key, 32, heads=2, dim_head=16, context_dim=16, image_cross=True,
        domain_cross=True)), 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((batch, 4, 4, 32)).astype(np.float32)
    ctx = rng.standard_normal((batch, 77 + 16, 16)).astype(np.float32)
    ref = jax.jit(lambda p, x, c: JA.spatial_transformer(p, x, c, heads=2, image_cross=True,
                                                         num_tasks=3))(
        to_jax(tree), jnp.asarray(x), jnp.asarray(ctx))
    m = port(TA.SpatialTransformer(32, heads=2, dim_head=16, context_dim=16, image_cross=True,
                                   domain_cross=True), tree)
    with torch.no_grad():
        ours = m(t(x), t(ctx), image_cross=True, num_tasks=3)
        with pytest.raises(ValueError, match="not divisible"):
            m(t(x[:2]), t(ctx[:2]), image_cross=True, num_tasks=3)
    assert_close(ours, ref, TOL, ATOL, "joint")


def test_cross_context_temporal_transformer():
    """The cross-context path: frame j's context rows repeated (h*w)//t
    times; h*w that t does not divide raises, as in JAX."""
    key = jax.random.PRNGKey(0)
    tree = random_tree(jax.eval_shape(lambda: JA.init_temporal_transformer(
        key, 32, heads=2, dim_head=16, context_dim=16)), 7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, T_, 4, 4, 32)).astype(np.float32)
    ctx = rng.standard_normal((2 * T_, 93, 16)).astype(np.float32)
    ref = jax.jit(lambda p, x, c: JA.temporal_transformer(   # causal is ignored there
        p, x, c, heads=2, causal=True, temporal_length=L_))(to_jax(tree), jnp.asarray(x),
                                                            jnp.asarray(ctx))
    m = port(TA.TemporalTransformer(32, heads=2, dim_head=16, context_dim=16), tree)
    with torch.no_grad():
        ours = m(t(x), t(ctx), causal=True, temporal_length=L_)
        with pytest.raises(ValueError, match="reference repeat semantics"):
            m(t(x[:, :, :3, :3]), t(ctx))
    with pytest.raises(ValueError, match="reference repeat semantics"):
        JA.temporal_transformer(to_jax(tree), jnp.asarray(x[:, :, :3, :3]), jnp.asarray(ctx),
                                heads=2)
    assert_close(ours, ref, TOL, ATOL, "cross-context")


# ---------------------------------------------------------------------------
# the option UNets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_unet_forward_matches_jax(name):
    """The tiny UNet with each of phase 19 (d)'s option sets, at its batch
    (the joint one at one sample a task)."""
    cfg_kw = {**TINY, **OPTIONS[name]}
    batch = CS.OPTION_BATCH[name]
    jcfg = JU.UNetConfig(**cfg_kw)
    tree = random_tree(jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), jcfg)), 9)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((batch, T_, 8, 8, 12)).astype(np.float32)
    ctx = _ctx(rng, batch)
    ts = np.array([999, 421, 17][:batch], np.int64)
    lab = np.array([0, 500, 1000][:batch], np.int64)
    ref = jax.jit(lambda p, x, ts, c, lab: JU.unet_apply(p, jcfg, x, ts, c, c_label=lab))(
        to_jax(tree), jnp.asarray(x), jnp.asarray(ts, jnp.int32), jnp.asarray(ctx),
        jnp.asarray(lab, jnp.int32))
    unet = port(TU.UNet3D(TU.UNetConfig(**cfg_kw)), tree)
    with torch.no_grad():
        ours = unet(t(x), t(ts), t(ctx), c_label=t(lab))
    assert float(np.abs(np.asarray(ref)).max()) > 0.05
    assert_close(ours, ref, TOL, ATOL, name)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_trees_match_meta_modules(name, tmp_path):
    """At full width, every JAX leaf of the option UNet has a port parameter
    of its torch shape and nothing else exists; at the tiny config a MuDG
    .ckpt of its tree imports (the new leaves carried, none refused) and
    loads strictly, equal to convert's state dict."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: JU.init_unet(key, JU.UNetConfig(**OPTIONS[name])))
    stubs = jax.tree.map(lambda v: np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), v.shape, (0,) * len(v.shape)), shapes)
    want = {k: tuple(v.shape) for k, v in pytree_to_state_dict(stubs).items()}
    with torch.device("meta"):
        got = {k: tuple(v.shape) for k, v in
               TU.UNet3D(TU.UNetConfig(**OPTIONS[name])).state_dict().items()}
    assert got == want
    cfg = JU.UNetConfig(**{**TINY, **OPTIONS[name]})
    tree = random_tree(jax.eval_shape(lambda: JU.init_unet(key, cfg)), 11)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          pytree_to_state_dict(tree, prefix="model.diffusion_model.").items()}
    torch.save({"state_dict": sd}, tmp_path / "m.ckpt")
    ours = TC.load_mudg_checkpoint(str(tmp_path / "m.ckpt"))["unet"]
    ref = convert.tree_to_state_dict(tree)
    assert sorted(ours) == sorted(ref)
    assert all(torch.equal(ours[k], v) for k, v in ref.items())
    TU.UNet3D(TU.UNetConfig(**{**TINY, **OPTIONS[name]})).load_state_dict(ours, strict=True)
    if name == "relpos_causal_joint":
        for leaf in ("relative_position_k.embeddings_table", "attn_joint.to_q.weight",
                     "norm_joint.weight"):
            assert any(k.endswith(leaf) for k in ours), leaf
        assert got["init_attn.0.transformer_blocks.0.attn1.relative_position_v."
                   "embeddings_table"] == (2 * 16 + 1, 64)
    else:   # the temporal attn2's keys and values read the 1024-wide context
        assert got["input_blocks.1.2.transformer_blocks.0.attn2.to_k.weight"] == (320, 1024)
        assert got["init_attn.0.transformer_blocks.0.attn2.to_v.weight"] == (512, 1024)


JAX_KERNELS = ((JSP, "fused_self_attention", "spatial_attn"),
               (JSP, "stream_self_attention", "spatial_attn"),
               (JSP, "flashblock_self_attention", "spatial_attn"),
               (JTA, "fused_double_self_attn", "temporal_attn"),
               (JM, "fused_geglu_ff", "geglu_ff"), (JM, "fused_geglu_ff_block", "geglu_ff"),
               (JTC, "fused_gn_silu_tconv", "gn_silu_tconv"),
               (JFA, "flash_attention", "flash_attention"))


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_sites_match_the_jax_trace(monkeypatch, name):
    """One full-width bf16 forward of each option UNet at phase 19 (d)'s
    batch and latent: the port's kernel wrappers (meta device) are called
    exactly as often as `jax.eval_shape` of the JAX UNet calls its kernels,
    and chip_smoke.py's OPTION_SITES holds those counts; the cross-context
    UNet at the MDM512 latent raises in both (40 % 16 at ds8)."""
    jcalls = collections.Counter()
    for mod, fn, kname in JAX_KERNELS:
        def fake(*a, _name=kname, **k):
            jcalls[_name] += 1
            return a[0]
        monkeypatch.setattr(mod, fn, fake)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jcfg = JU.UNetConfig(**OPTIONS[name])
    batch = CS.OPTION_BATCH[name]
    h, w = CS.LATENT[CS.OPTION_LATENT[name]]
    S = jax.ShapeDtypeStruct
    params = jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), jcfg))
    jax.eval_shape(lambda p, x, ts, c, lab: JU.unet_apply(p, jcfg, x, ts, c, c_label=lab),
                   params, S((batch, 16, h, w, 12), jnp.bfloat16), S((batch,), jnp.int32),
                   S((batch, 77 + 256, 1024), jnp.bfloat16), S((batch,), jnp.int32))
    calls = count_kernel_calls(monkeypatch)
    bf = torch.bfloat16
    with torch.device("meta"), torch.no_grad():
        unet = TU.UNet3D(TU.UNetConfig(**OPTIONS[name])).to(bf)
        ctx = torch.empty(batch, 77 + 256, 1024, dtype=bf)
        ts = torch.zeros(batch, dtype=torch.int64)
        unet(torch.empty(batch, 16, h, w, 12, dtype=bf), ts, ctx, c_label=ts)
        got = dict(calls)
        if name == "context":
            with pytest.raises(ValueError, match="reference repeat semantics"):
                unet(torch.empty(batch, 16, *CS.LATENT["mdm512"], 12, dtype=bf), ts, ctx,
                     c_label=ts)
    expect = {k: jcalls.get(k, 0) for k in calls}
    assert got == expect
    assert {k: v for k, v in CS.OPTION_SITES[name].items() if k in calls} == expect
    assert expect["temporal_attn"] == 0   # kernel 2 stays off under every option


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------

SHAPE = (2, 3, 4, 5, 4)


def _model_fns(seed=12):
    """A closed-form denoiser in JAX and in torch: v = tanh(a x + b t / 1000)
    with seeded a, b."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(SHAPE[1:]) * 0.5).astype(np.float32)
    b = np.float32(rng.standard_normal())

    def jfn(x, tt):
        return jnp.tanh(a * x + b * tt.astype(jnp.float32).reshape(-1, 1, 1, 1, 1) / 1000.0)

    ta = torch.from_numpy(a)

    def tfn(x, tt):
        return torch.tanh(ta * x + b * tt.float().reshape(-1, 1, 1, 1, 1) / 1000.0)

    return jfn, tfn


def _mask_inputs(seed=13):
    rng = np.random.default_rng(seed)
    mask = (rng.random(SHAPE) > 0.5).astype(np.float32)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    x_T = rng.standard_normal(SHAPE).astype(np.float32)
    return mask, x0, x_T


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(ours).all()
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_masked_ddim_matches_jax(eta):
    """DDIM with the latent mask blend at 6 steps, JAX's step and q-sample
    draws passed in (per step: rng -> rng, kn, kq)."""
    jfn, tfn = _model_fns()
    mask, x0, x_T = _mask_inputs()
    jsched = JS.DiffusionSchedule.create()
    tsched = TS.DiffusionSchedule.create()
    steps = 6
    jc = JDDIM.make_ddim_constants(jsched, steps, eta=eta)
    rng = jax.random.PRNGKey(3)
    ref = JDDIM.ddim_sample(jfn, rng, SHAPE, jc, x_T=jnp.asarray(x_T), mask=jnp.asarray(mask),
                            x0=jnp.asarray(x0), sched=jsched)
    key, _ = jax.random.split(rng)   # ddim_sample: rng, k0 = split(rng)
    noise, noise_q = [], []
    for _ in range(steps):
        key, kn, kq = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(kn, SHAPE)))
        noise_q.append(np.asarray(jax.random.normal(kq, SHAPE)))
    draws = {"noise": t(np.stack(noise)), "noise_q": t(np.stack(noise_q))}
    tc = TDDIM.make_ddim_constants(tsched, steps, eta=eta)
    ours = TDDIM.ddim_sample(tfn, None, SHAPE, tc, x_T=t(x_T), mask=t(mask), x0=t(x0),
                             sched=tsched, draws=draws)
    assert _rel(ours, ref) <= SAMPLER_TOL
    # the generator form draws the same number of tensors and stays finite
    gen = TDDIM.ddim_sample(tfn, torch.Generator().manual_seed(0), SHAPE, tc, mask=t(mask),
                            x0=t(x0), sched=tsched)
    assert torch.isfinite(gen).all()


def test_masked_dpm_matches_jax():
    """DPM-Solver++(2M) with the latent mask blend at 6 steps, JAX's
    q-sample draws passed in (per step: rng -> rng, kq)."""
    jfn, tfn = _model_fns(14)
    mask, x0, x_T = _mask_inputs(15)
    jsched = JS.DiffusionSchedule.create()
    tsched = TS.DiffusionSchedule.create()
    steps = 6
    rng = jax.random.PRNGKey(5)
    ref = JDPM.dpmpp_sample(jfn, rng, SHAPE, JDPM.make_dpmpp_constants(jsched, steps),
                            x_T=jnp.asarray(x_T), mask=jnp.asarray(mask), x0=jnp.asarray(x0),
                            sched=jsched)
    key, _ = jax.random.split(rng)   # dpmpp_sample: rng, k0 = split(rng)
    noise_q = []
    for _ in range(steps):
        key, kq = jax.random.split(key)
        noise_q.append(np.asarray(jax.random.normal(kq, SHAPE)))
    ours = TDPM.dpmpp_sample(tfn, None, SHAPE, TDPM.make_dpmpp_constants(tsched, steps),
                             x_T=t(x_T), mask=t(mask), x0=t(x0), sched=tsched,
                             draws={"noise_q": t(np.stack(noise_q))})
    assert _rel(ours, ref) <= SAMPLER_TOL


@pytest.mark.parametrize("index", [0, 3, "batch"])
def test_stochastic_encode_matches_jax(index):
    rng = np.random.default_rng(16)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    idx = np.array([1, 4]) if index == "batch" else index
    jc = JDDIM.make_ddim_constants(JS.DiffusionSchedule.create(), 6)
    tc = TDDIM.make_ddim_constants(TS.DiffusionSchedule.create(), 6)
    ref = JDDIM.stochastic_encode(jnp.asarray(x0), jnp.asarray(idx), jc, jnp.asarray(noise))
    ours = TDDIM.stochastic_encode(t(x0), idx, tc, t(noise))
    assert _rel(ours, ref) <= SAMPLER_TOL


@pytest.mark.parametrize("param,clip", [("v", False), ("eps", False), ("eps", True),
                                        ("x0", False), ("x0", True)])
def test_ddpm_sample_matches_jax(param, clip):
    """All 1000 ancestral steps, JAX's start noise and step draws passed in
    (rng -> rng, k0; per step rng -> rng, kn). eps without clipping runs
    through the terminal step's sqrt(1/ac - 1) = 1e10 (ac floored at 1e-20
    at zero terminal SNR), as JAX does."""
    jfn, tfn = _model_fns(17)
    if param == "x0":
        jfn0, tfn0 = jfn, tfn
        jfn = lambda x, tt: 2.0 * jfn0(x, tt)          # noqa: E731  (reaches the clip)
        tfn = lambda x, tt: 2.0 * tfn0(x, tt)          # noqa: E731
    jsched = JS.DiffusionSchedule.create(parameterization=param if param != "x0" else "v")
    tsched = TS.DiffusionSchedule.create(parameterization=param if param != "x0" else "v")
    rng = jax.random.PRNGKey(7)
    ref = JDDIM.ddpm_sample(jfn, rng, SHAPE, jsched, parameterization=param,
                            clip_denoised=clip)
    key, k0 = jax.random.split(rng)
    x_T = np.asarray(jax.random.normal(k0, SHAPE))
    noise = []
    for _ in range(jsched.num_timesteps):
        key, kn = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(kn, SHAPE)))
    ours = TDDIM.ddpm_sample(tfn, None, SHAPE, tsched, parameterization=param,
                             clip_denoised=clip, device="cpu", x_T=t(x_T),
                             draws={"noise": t(np.stack(noise))})
    assert_close(ours, ref, TOL, ATOL, f"ddpm {param} clip={clip}")
