"""PyTorch port vs JAX for the MDM1024 serving path through `sample`: the
plain attention against the Pallas flash kernel (kernel 5) and the plain
spatial block against the long-L tiers of kernel 1 (TPU kernels 7 and 8),
both in Pallas interpret mode; the chunked plain attention; `sample` in its
2-point, 3-point, moments and DPM-Solver++ forms against JAX `sample`; the
DPM-Solver++ constants and steps; and the MDM1024 kernel dispatch sites.

Tolerances: the kernels' 3e-2 * max|ref| of tests/test_attention.py:47,345,502
where a Pallas kernel is the reference; 2e-3 * max|ref| + 5e-5 for the fp32
compositions (tests/test_reference_oracle.py:50).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mudg_tpu.diffusion import dpm as JDPM
from mudg_tpu.kernels import flash_attention as JFA
from mudg_tpu.kernels import mlp as JM
from mudg_tpu.kernels import spatial_attn as JSP
from mudg_tpu.kernels import tconv as JTC
from mudg_tpu.kernels import temporal_attn as JTA
from mudg_tpu.models import mdm as JMDM
from mudg_tpu.models import presets as JP
from mudg_tpu.nn import attention as JA
from mudg_tpu_torch.diffusion import dpm as TDPM
from mudg_tpu_torch.kernels import flash_attention as FA
from mudg_tpu_torch.kernels import mlp as M
from mudg_tpu_torch.kernels import spatial_attn as SP
from mudg_tpu_torch.kernels import tconv as TC
from mudg_tpu_torch.kernels import temporal_attn as TA
from mudg_tpu_torch.models import mdm as TMDM
from mudg_tpu_torch.models import presets as TP
from mudg_tpu_torch.nn import attention as TAT
from mudg_tpu_torch.nn import unet3d as TU
from test_torch_util import assert_close, count_kernel_calls, port, random_tree, t, to_jax

KTOL = 3e-2
TOL, ATOL = 2e-3, 5e-5
F32 = np.float32


def test_flash_wrapper_matches_pallas_flash():
    """o and the natural-log lse of the port's kernel-5 wrapper (on the CPU:
    its plain version) against the Pallas forward, (1, 128, 2, 64)."""
    rng = np.random.default_rng(20)
    q, k, v = (rng.standard_normal((1, 128, 2, 64)).astype(F32) for _ in range(3))
    qf, kf, vf = JFA._fold(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o_ref, lse_ref = JFA._flash_fwd(qf, kf, vf)
    o, lse = FA.flash_attention(t(q), t(k), t(v))
    assert o.shape == q.shape and lse.shape == (2, 128) and lse.dtype == torch.float32
    assert_close(o, JFA._unfold(o_ref, q.shape), KTOL, 0.0, "flash o")
    assert_close(lse, lse_ref[..., 0], KTOL, 0.0, "flash lse")
    assert_close(o, JFA.flash_attention(*map(jnp.asarray, (q, k, v))), KTOL, 0.0, "public op")


@pytest.mark.parametrize("tier,l", [("stream", 4 * JSP._STREAM_BQ), ("flashblock", 1024)])
def test_spatial_block_matches_long_l_tiers(tier, l):
    """Kernel 1's wrapper (on the CPU: its plain version) against TPU kernel
    7 (`_stream_impl`, 4 q-chunks) and kernel 8 (`_fb_impl`, 2 k/v chunks)."""
    heads, c = 2, 128
    key = jax.random.PRNGKey(0)
    p_attn = random_tree(jax.eval_shape(
        lambda: JA.init_cross_attention(key, c, heads=heads, dim_head=64)), 30)
    p_norm = random_tree({"weight": jax.ShapeDtypeStruct((c,), jnp.float32),
                          "bias": jax.ShapeDtypeStruct((c,), jnp.float32)}, 31)
    x = np.random.default_rng(32).standard_normal((2, l, c)).astype(F32)
    impl = JSP._stream_impl if tier == "stream" else JSP._fb_impl
    ref = impl(jnp.asarray(x), to_jax(p_norm), to_jax(p_attn), heads=heads)
    norm = port(nn.LayerNorm(c), p_norm)
    attn = port(TAT.CrossAttention(c, heads=heads, dim_head=64), p_attn)
    with torch.no_grad():
        ours = SP.fused_self_attention(t(x), norm, attn, heads)
    assert_close(ours, ref, KTOL, 0.0, tier)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("pairs", [1, 2, 9])
def test_chunked_plain_attend_equals_unchunked(monkeypatch, causal, pairs):
    """The (batch, head) chunking of the plain attention changes nothing:
    o and lse are bit-equal to one pass, causal (Lq < Lk) or not."""
    rng = np.random.default_rng(33)
    lq, lk = (64, 96) if causal else (96, 96)
    q = t(rng.standard_normal((3, lq, 4, 16)).astype(F32))
    k, v = (t(rng.standard_normal((3, lk, 4, 16)).astype(F32)) for _ in range(2))
    o1, lse1 = TAT.plain_attend(q, k, v, causal=causal, with_lse=True)
    monkeypatch.setattr(TAT, "LOGITS_BUDGET", pairs * lq * lk * 4)
    o2, lse2 = TAT.plain_attend(q, k, v, causal=causal, with_lse=True)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    assert torch.equal(TAT.attend(q, k, v, causal=causal), o1)


# ---------------------------------------------------------------------------
# sample
# ---------------------------------------------------------------------------

B, T, H, W = 1, 4, 16, 16
STEPS = 2


@pytest.fixture(scope="module")
def tiny_mdm():
    cfg = JP.tiny()
    tree = random_tree(jax.eval_shape(lambda: JMDM.init_mdm(jax.random.PRNGKey(0), cfg)), 40)
    rng = np.random.default_rng(41)
    data = dict(
        sparse_frames=rng.uniform(-1, 1, (B, T, H, W, 3)).astype(F32),
        sparse_depth=rng.uniform(-1, 1, (B, T, H, W, 3)).astype(F32),
        sparse_moments=(rng.standard_normal((B, T, H // 2, W // 2, 8)) * 0.5).astype(F32),
        depth_moments=(rng.standard_normal((B, T, H // 2, W // 2, 8)) * 0.5).astype(F32),
        tokens=rng.integers(0, cfg.clip_text.vocab_size, (B, 77)).astype(np.int32),
        null_tokens=rng.integers(0, cfg.clip_text.vocab_size, (77,)).astype(np.int32),
        class_label=np.array([500], np.int32),
    )
    return cfg, tree, port(TMDM.MDM(TP.tiny()), tree), data


@pytest.mark.parametrize("form", ["cfg2", "cfg3", "moments-dpmpp"])
def test_sample_matches_jax_sample(tiny_mdm, form):
    """The port's `sample` against JAX `sample` (2 steps, DDIM at eta 0 or
    DPM-Solver++): both start from the noise JAX `sample` draws from its
    key, which the port is given as x_T. Conditions from pixels (VAE
    encode) with 2- or 3-point CFG, or from moments + frame0."""
    cfg, tree, mdm, data = tiny_mdm
    names = (("sparse_moments", "depth_moments") if form == "moments-dpmpp"
             else ("sparse_frames", "sparse_depth")) + ("tokens", "null_tokens", "class_label")
    inputs = {n: data[n] for n in names}
    if form == "moments-dpmpp":
        inputs["frame0"] = data["sparse_frames"][:, 0]
    kw = dict(num_steps=STEPS, guidance_scale=7.5, guidance_rescale=0.7, eta=0.0,
              timestep_spacing="uniform_trailing",
              multiple_cond_cfg=form == "cfg3", cfg_img=3.0 if form == "cfg3" else None,
              sampler="dpmpp" if form == "moments-dpmpp" else "ddim")
    key = jax.random.PRNGKey(7)
    ref = JMDM.sample(to_jax(tree), cfg, key, **{n: jnp.asarray(a) for n, a in inputs.items()},
                      **kw)
    x_T = jax.random.normal(jax.random.split(key)[1], (B, T, H // 2, W // 2, 4), jnp.float32)
    ours = TMDM.sample(mdm, generator=torch.Generator().manual_seed(0), x_T=t(x_T),
                       **{n: t(a).long() if a.dtype.kind == "i" else t(a)
                          for n, a in inputs.items()}, **kw)
    assert ours.shape == (B, T, H, W, 3) and ours.dtype == torch.float32
    assert float(np.abs(np.asarray(ref)).max()) > 0.05   # the clip carries signal
    assert_close(ours, ref, TOL, ATOL, form)


def test_dpmpp_constants_and_steps_match_jax():
    sched = JMDM.MDMConfig().schedule()
    cj = JDPM.make_dpmpp_constants(sched, 25)
    ct = TDPM.make_dpmpp_constants(TMDM.MDMConfig().schedule(), 25)
    np.testing.assert_array_equal(np.asarray(cj.ts), ct.ts.numpy())
    for name, a, b in zip(cj._fields, cj, ct):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    # first order on the first two steps (no previous x0; the terminal step's
    # log-SNR interval is infinite) and on the last (lower_order_final)
    assert float(ct.g1[0]) == float(ct.g1[1]) == float(ct.g1[-1]) == 0.0
    assert float(ct.g1[2]) > 0.0

    x_T = np.random.default_rng(42).standard_normal((2, 3, 4, 4, 4)).astype(F32)
    cj2 = JDPM.make_dpmpp_constants(JMDM.stage2_config().schedule(), 2)
    ct2 = TDPM.make_dpmpp_constants(TMDM.stage2_config().schedule(), 2)

    def model(x, tt, np_):
        return 0.8 * x - 0.3 * np_.sin(x) + tt.reshape(-1, 1, 1, 1, 1) / 1000.0

    ref = JDPM.dpmpp_sample(lambda x, tt: model(x, tt.astype(jnp.float32), jnp),
                            jax.random.PRNGKey(0), x_T.shape, cj2, x_T=jnp.asarray(x_T))
    ours = TDPM.dpmpp_sample(lambda x, tt: model(x, tt.float(), torch), torch.Generator(),
                             x_T.shape, ct2, x_T=t(x_T))
    assert_close(ours, ref, 1e-5, 1e-6, "dpmpp")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_mdm1024_jax_and_port_predicates_agree(monkeypatch):
    """Every MDM1024 site shape (batch 2, 16 frames, 72x128 latent) under
    the JAX dispatch predicates (the TPU backend check taken as true) and
    the port's: spatial ds1 -> TPU kernel 8 (flash-block tier), ds2 ->
    kernel 7 (streaming tier), both kernel 1 here; ds4 C=1280 -> no spatial
    tier, so `attend` at L=576 -> kernel 5; ds8 L=144 -> dense."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    S, bf = jax.ShapeDtypeStruct, jnp.bfloat16
    tbf = torch.bfloat16

    def jax_tier(l, c):
        x = S((32, l, c), bf)
        for name, pred in (("fused", JSP.eligible), ("stream", JSP.stream_eligible),
                           ("flashblock", JSP.flashblock_eligible)):
            if pred(x, c, c // 64):
                return name
        return None

    assert jax_tier(9216, 320) == "flashblock" and jax_tier(2304, 640) == "stream"
    assert jax_tier(576, 1280) is None and jax_tier(144, 1280) is None
    for l, c, site in ((9216, 320, True), (2304, 640, True), (576, 1280, False),
                       (144, 1280, False)):
        assert SP.eligible((32, l, c), tbf, c, c // 64) == site
    for rows, c, site in ((18432, 320, True), (18432, 512, True), (4608, 640, True),
                          (1152, 1280, False)):
        assert JTA.eligible(S((rows, 16, c), bf), c, c // 64, 16) == site
        assert TA.eligible((rows, 16, c), tbf, c, c // 64) == site
    for m, c in ((294912, 320), (294912, 512), (73728, 640), (18432, 1280), (4608, 1280)):
        assert JM.geglu_ff_eligible(S((m, c), bf), S((c, 8 * c), bf))
        assert M.eligible((m, c), tbf, 4 * c)
    for c, site in ((320, True), (640, False), (1280, False)):
        assert JTC.eligible(S((2, 16, 72, 128, c), bf), {"weight": S((3, 1, 1, c, c), bf)}) == site
        assert TC.eligible((2, 16, 72, 128, c), tbf, (c, c, 3, 1, 1)) == site
    for l, site in ((576, True), (144, False)):   # attend's flash condition
        q = torch.empty(32, l, 20, 64, dtype=tbf, device="meta")
        assert (l >= JA.FLASH_MIN_SEQ and l % 64 == 0) == site
        assert (l >= TAT.FLASH_MIN_SEQ and FA.eligible(q, q, q)) == site


def test_mdm1024_dispatch_sites(monkeypatch):
    """One full-width MDM1024 UNet forward (batch 2, 16 frames, 72x128,
    bf16), traced on the meta device, reaches the kernel wrappers at 10
    spatial, 11 temporal, 33 FF, 20 tconv and 5 flash-attention sites."""
    calls = count_kernel_calls(monkeypatch)
    bf = torch.bfloat16
    with torch.device("meta"), torch.no_grad():
        unet = TU.UNet3D(TU.UNetConfig()).to(bf)
        x = torch.empty(2, 16, 72, 128, 12, dtype=bf)
        ctx = torch.empty(2, 77 + 256, 1024, dtype=bf)
        ts = torch.zeros(2, dtype=torch.int64)
        assert unet(x, ts, ctx, c_label=ts).shape == (2, 16, 72, 128, 4)
    assert calls == {"spatial_attn": 10, "temporal_attn": 11, "geglu_ff": 33,
                     "gn_silu_tconv": 20, "flash_attention": 5}
