"""Kernels 11 and 12 of the PyTorch port (`mudg_tpu_torch/kernels/norms.py`,
`kernels/short_attention.py`) against the JAX package, on the CPU.

- Each plain version against its Pallas function run as
  tests/test_fused_norms.py and tests/test_short_kernels.py run it (interpret
  mode on the CPU): fp32 within atol 2e-5, bf16 within 2e-2.
- Each autograd op's gradient against jax.grad of the JAX function (its
  custom_vjp backward): atol 1e-4 for the norms, 2e-4 for attention.
- The copied fit and eligibility predicates against the JAX ones.
- The known difference: under a DC offset of 1e3 the Pallas GroupNorm's
  one-pass variance parts from `_gn_reference`, the port's does not.
- The sites: with MUDG_FUSED_NORMS=1 and MUDG_SHORT_ATTN=1 and the CUDA
  check taken as true, full-width MDM512 and MDM1024 UNet forwards, training
  micro-steps, the VAE and the resampler traced on the meta device call the
  kernel-11/12 wrappers at exactly the calls the JAX predicates admit (the
  TPU backend check taken as true), and chip_smoke.py's expected launch
  counts are those numbers; with the switches unset, at none.
- The slice: the tiny-config UNet with both switches on (the wrappers'
  plain versions on the CPU) against the JAX UNet.

Inputs are made from numpy seeds and fed to both sides.
"""
from __future__ import annotations

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from mudg_tpu.kernels import norms as JN
from mudg_tpu.kernels import short_attention as JSA
from mudg_tpu.nn import attention as JA
from mudg_tpu.nn import unet3d as JU
from mudg_tpu_torch.kernels import flash_attention as FA
from mudg_tpu_torch.kernels import mlp as M
from mudg_tpu_torch.kernels import norms as N
from mudg_tpu_torch.kernels import short_attention as SA
from mudg_tpu_torch.kernels import spatial_attn as SP
from mudg_tpu_torch.kernels import tconv as TC
from mudg_tpu_torch.kernels import temporal_attn as TA
from mudg_tpu_torch.models import mdm as TMDM
from mudg_tpu_torch.models import presets as TP
from mudg_tpu_torch.nn import attention as TAT
from mudg_tpu_torch.nn import functional as TF
from mudg_tpu_torch.nn import unet3d as TU
from mudg_tpu_torch.nn import vae as TV
from test_torch_model import SLICE_ATOL, SLICE_TOL, TINY_UNET
from test_torch_util import assert_close, port, random_tree, t, to_jax

F32_ATOL, BF16_ATOL = 2e-5, 2e-2     # tests/test_fused_norms.py, tests/test_short_kernels.py
NORM_GRAD_ATOL, ATTN_GRAD_ATOL = 1e-4, 2e-4


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _norm_inputs(shape, seed, dtype=np.float32, offset=0.0, scale=2.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale + offset + 1.0).astype(np.float32)
    c = shape[-1]
    w = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    b = (0.3 * rng.standard_normal(c)).astype(np.float32)
    return x, w, b


def _both(x, dtype):
    """(torch tensor, jax array) of x in dtype ("f32" or "bf16")."""
    if dtype == "bf16":
        xt = torch.from_numpy(x).bfloat16()
        return xt, jnp.asarray(x).astype(jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,groups,dtype", [((3, 8, 8, 64), 8, "f32"),
                                                 ((2, 3, 4, 4, 32), 4, "f32"),
                                                 ((2, 4, 4, 32), 4, "bf16"),
                                                 ((2, 3, 4, 4, 32), 4, "bf16")])
def test_group_norm_plain_matches_pallas(shape, groups, dtype):
    x, w, b = _norm_inputs(shape, 0)
    xt, xj = _both(x, dtype)
    ref = JN.fused_group_norm(xj, jnp.asarray(w), jnp.asarray(b), groups, 1e-5)
    got = N.fused_group_norm(xt, torch.from_numpy(w), torch.from_numpy(b), groups, 1e-5)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), _np(ref), atol=F32_ATOL if dtype == "f32" else BF16_ATOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_plain_matches_pallas(dtype):
    x, w, b = _norm_inputs((3, 64, 96), 1)
    xt, xj = _both(x, dtype)
    ref = JN.fused_layer_norm(xj, jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = N.fused_layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(ref), atol=F32_ATOL if dtype == "f32" else BF16_ATOL)


def _qkv(shapes, seed, dtype="f32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return [_both(a, dtype) for a in arrs]


@pytest.mark.parametrize("lq,lk,dtype", [(512, 93, "f32"), (256, 16, "f32"), (256, 640, "f32"),
                                         (256, 77, "bf16"), (256, 1024, "f32")])
def test_short_kv_plain_matches_pallas(lq, lk, dtype):
    b, h, d = 2, 2, 64
    (qt, qj), (kt, kj), (vt, vj) = _qkv([(b, lq, h, d), (b, lk, h, d), (b, lk, h, d)], 2, dtype)
    assert SA.short_kv_attention_eligible(qt, kt)
    ref = JSA.short_kv_attention(qj, kj, vj)
    got = SA.short_kv_attention(qt, kt, vt)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), _np(ref), atol=F32_ATOL if dtype == "f32" else BF16_ATOL)


@pytest.mark.parametrize("lq,lk,dtype", [(256, 77, "bf16"), (256, 77, "f32")])
def test_short_kv_plain_matches_pallas_head_dim_128(lq, lk, dtype):
    """Head dim 128, which no MuDG site reaches: the predicate admits it."""
    b, h, d = 2, 2, 128
    (qt, qj), (kt, kj), (vt, vj) = _qkv([(b, lq, h, d), (b, lk, h, d), (b, lk, h, d)], 4, dtype)
    assert SA.short_kv_attention_eligible(qt, kt)
    ref = JSA.short_kv_attention(qj, kj, vj)
    got = SA.short_kv_attention(qt, kt, vt)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), _np(ref), atol=F32_ATOL if dtype == "f32" else BF16_ATOL)


@pytest.mark.parametrize("b,tt,h,d,dtype", [(16, 16, 2, 64, "f32"), (8, 8, 4, 128, "f32"),
                                            (8, 4, 4, 64, "f32"), (16, 16, 2, 64, "bf16"),
                                            (64, 1, 2, 64, "bf16"), (4, 32, 1, 128, "bf16"),
                                            (2, 64, 2, 64, "f32")])
def test_packed_plain_matches_pallas(b, tt, h, d, dtype):
    (qt, qj), (kt, kj), (vt, vj) = _qkv([(b, tt, h, d)] * 3, 3, dtype)
    assert SA.packed_short_attention_eligible(qt)
    ref = JSA.packed_short_attention(qj, kj, vj)
    got = SA.packed_short_attention(qt, kt, vt)
    np.testing.assert_allclose(_np(got), _np(ref), atol=F32_ATOL if dtype == "f32" else BF16_ATOL)


# ---------------------------------------------------------------------------
# Gradients of the autograd ops against jax.grad of the JAX functions
# ---------------------------------------------------------------------------

def _torch_grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    torch.sin(fn(*ts)).sum().backward()
    return [x.grad.numpy() for x in ts]


def _jax_grads(fn, *arrays):
    return jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))), argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))


@pytest.mark.parametrize("kind", ["group_norm", "layer_norm"])
def test_norm_op_grads_match_jax(kind):
    if kind == "group_norm":
        x, w, b = _norm_inputs((2, 3, 4, 4, 16), 4)
        got = _torch_grads(lambda x, w, b: N.group_norm_op(x, w, b, 4, 1e-5), x, w, b)
        ref = _jax_grads(lambda x, w, b: JN.fused_group_norm(x, w, b, 4, 1e-5), x, w, b)
    else:
        x, w, b = _norm_inputs((2, 16, 32), 5)
        got = _torch_grads(lambda x, w, b: N.layer_norm_op(x, w, b, 1e-5), x, w, b)
        ref = _jax_grads(lambda x, w, b: JN.fused_layer_norm(x, w, b, 1e-5), x, w, b)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=NORM_GRAD_ATOL)


@pytest.mark.parametrize("kind", ["short_kv", "packed"])
def test_attention_op_grads_match_jax(kind):
    rng = np.random.default_rng(6)
    if kind == "short_kv":
        shapes = [(2, 256, 2, 64), (2, 77, 2, 64), (2, 77, 2, 64)]
        ops = SA.short_kv_attention_op, JSA.short_kv_attention
    else:
        shapes = [(8, 16, 2, 64)] * 3
        ops = SA.packed_short_attention_op, JSA.packed_short_attention
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    got = _torch_grads(ops[0], q, k, v)
    ref = _jax_grads(ops[1], q, k, v)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=ATTN_GRAD_ATOL)


# ---------------------------------------------------------------------------
# Predicates and the known difference
# ---------------------------------------------------------------------------

class Shape:
    """A stand-in for a JAX array in the JAX predicates: shape, dtype, ndim,
    size, and x[0]'s shape."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), jnp.dtype(dtype)
        self.ndim, self.size = len(self.shape), math.prod(self.shape)

    def __getitem__(self, i):
        return Shape(self.shape[1:], self.dtype)


def _jdt(dtype):
    return {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]


def test_predicates_match_jax():
    shapes = [(32, 40, 64, 320), (32, 72, 128, 320), (2, 16, 5, 8, 1280), (2, 16, 40, 64, 320),
              (16, 40, 64, 512), (1, 320, 512, 128), (32, 10, 16, 2560), (2, 8), (4, 7, 320),
              (32, 2560, 320), (32, 9216, 320), (2, 77, 1024), (2, 257, 1280), (2, 256, 1024),
              (1152, 16, 1280), (32, 40, 1280)]
    n = 0
    for shape in shapes:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.empty(shape, dtype=dt, device="meta")
            assert N.group_norm_fits(x) == JN.group_norm_fits(Shape(shape, _jdt(dt))), shape
            assert N.layer_norm_fits(x) == JN.layer_norm_fits(Shape(shape, _jdt(dt))), shape
            n += N.group_norm_fits(x) + N.layer_norm_fits(x)
    assert n > 10   # both predicates admit and refuse on this grid
    for lq, lk, d in [(2560, 77, 64), (2560, 16, 64), (640, 77, 64), (9216, 16, 64),
                      (512, 1024, 128), (512, 1025, 64), (256, 16, 32), (2304, 77, 64)]:
        q, k = torch.empty(2, lq, 5, d, device="meta"), torch.empty(2, lk, 5, d, device="meta")
        assert (SA.short_kv_attention_eligible(q, k)
                == JSA.short_kv_attention_eligible(Shape(q.shape, jnp.bfloat16),
                                                   Shape(k.shape, jnp.bfloat16))), (lq, lk, d)
    for b, tt, h, d in [(5120, 16, 5, 64), (8, 4, 4, 64), (8, 3, 4, 64), (1, 16, 1, 64),
                        (16, 128, 2, 64), (4, 8, 4, 128), (4, 8, 4, 96)]:
        q = torch.empty(b, tt, h, d, device="meta")
        assert (SA.packed_short_attention_eligible(q)
                == JSA.packed_short_attention_eligible(Shape(q.shape, jnp.bfloat16)))


def test_group_norm_dc_offset_known_difference():
    """At a DC offset of 1e3 (std 1), fp32: the port's plain version (centered
    variance) stays with `_gn_reference` (two-pass), while the Pallas
    kernel's one-pass E[x^2] - E[x]^2 loses the variance to cancellation.
    The tolerance is the fp32 slice tolerance of tests/test_reference_oracle.py
    (2e-3 * scale + 5e-5): a mean near 1e3 in fp32 carries ~3e-5 of rounding
    on either side."""
    x, w, b = _norm_inputs((2, 16, 16, 64), 7, offset=1e3, scale=1.0)
    wj, bj = jnp.asarray(w), jnp.asarray(b)
    ref = np.asarray(JN._gn_reference(jnp.asarray(x), wj, bj, 8, 1e-5))
    pallas = np.asarray(JN.fused_group_norm(jnp.asarray(x), wj, bj, 8, 1e-5))
    ours = N.fused_group_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 8,
                              1e-5).numpy()
    exact = N.plain_group_norm(torch.from_numpy(x).double(), torch.from_numpy(w).double(),
                               torch.from_numpy(b).double(), 8, 1e-5).numpy()
    scale = np.abs(exact).max()
    tol = SLICE_TOL * scale + SLICE_ATOL
    assert np.abs(ours - exact).max() <= tol
    assert np.abs(ref - exact).max() <= tol
    assert np.abs(pallas - exact).max() > 10 * tol
    one_pass = N.plain_group_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                  8, 1e-5, one_pass=True).numpy()
    assert np.abs(one_pass - exact).max() > 10 * tol   # the planted fault of chip_smoke.py


# ---------------------------------------------------------------------------
# Sites: the port's wrappers against the JAX predicates, on the meta device
# ---------------------------------------------------------------------------

# the other kernels' wrappers and ops: on the card they run CUDA kernels and
# reach no dispatch point; on the meta device their plain versions would
OPAQUE = [(SP, "fused_self_attention"), (TA, "fused_double_self_attn"),
          (M, "fused_geglu_ff"), (M, "fused_geglu_ff_block"), (TC, "fused_gn_silu_tconv"),
          (FA, "flash_attention"), (FA, "flash_attention_train"),
          (TA, "double_self_attn_train"), (M, "geglu_ff_train"), (M, "geglu_ff_block_train")]
KEYS = ("group_norm", "layer_norm", "short_kv_attention")


class Sites:
    """Counts, in the current phase ("fwd" or "bwd"), the calls of the
    kernel-11/12 wrappers and the dispatch-point calls the JAX predicates
    admit, outside the other kernels' wrappers, with the switches set (or
    not) and the CUDA check taken as true. `shapes` collects each admitted
    call's (kernel, shape, dtype)."""

    def __init__(self, monkeypatch, switches=True):
        self.phase = "fwd"
        self.calls = {"fwd": collections.Counter(), "bwd": collections.Counter()}
        self.admits = {"fwd": collections.Counter(), "bwd": collections.Counter()}
        self.shapes = collections.Counter()
        self.depth = 0
        for var in ("MUDG_FUSED_NORMS", "MUDG_SHORT_ATTN"):
            if switches:
                monkeypatch.setenv(var, "1")
            else:
                monkeypatch.delenv(var, raising=False)
        monkeypatch.setattr(TF, "on_card", lambda x: True)
        for mod, name in OPAQUE:
            self._opaque(monkeypatch, mod, name)
        for mod, name, key in ((N, "fused_group_norm", "group_norm"),
                               (N, "fused_layer_norm", "layer_norm"),
                               (SA, "short_kv_attention", "short_kv_attention")):
            self._count(monkeypatch, mod, name, key)
        self._judge(monkeypatch, TF, "group_norm", "group_norm", self._jax_gn)
        self._judge(monkeypatch, TF, "layer_norm", "layer_norm", self._jax_ln)
        self._judge(monkeypatch, TAT, "attend", "short_kv_attention", self._jax_attend)
        self.switches = switches

    def _opaque(self, mp, mod, name):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            self.depth += 1
            try:
                return orig(*a, **k)
            finally:
                self.depth -= 1
        mp.setattr(mod, name, wrapped)

    def _count(self, mp, mod, name, key):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            if not self.depth:
                self.calls[self.phase][key] += 1
            return orig(*a, **k)
        mp.setattr(mod, name, wrapped)

    def _judge(self, mp, mod, name, key, judge):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            if not self.depth and self.switches:
                shape = judge(*a, **k)
                if shape:
                    self.admits[self.phase][key] += 1
                    if self.phase == "fwd":
                        self.shapes[(key, *shape)] += 1
            return orig(*a, **k)
        mp.setattr(mod, name, wrapped)

    @staticmethod
    def _jax_gn(m, x, num_groups=32, eps=1e-5):
        ok = JN.group_norm_fits(Shape(x.shape, _jdt(x.dtype)))
        return ok and (tuple(x.shape), str(x.dtype))

    @staticmethod
    def _jax_ln(m, x, eps=1e-5):
        ok = JN.layer_norm_fits(Shape(x.shape, _jdt(x.dtype)))
        return ok and (tuple(x.shape), str(x.dtype))

    @staticmethod
    def _jax_attend(q, k, v, *, causal=False, impl="auto"):
        # JAX attend (attention.py:63-113): the flash test first, then short-KV
        flash = (q.shape[1] == k.shape[1] and q.shape[1] % 64 == 0 and q.shape[-1] % 64 == 0
                 and q.shape[1] >= JA.FLASH_MIN_SEQ)
        ok = (impl in ("auto", "train") and not causal and not flash
              and JSA.short_kv_attention_eligible(Shape(q.shape, jnp.bfloat16),
                                                  Shape(k.shape, jnp.bfloat16)))
        return ok and (tuple(q.shape), tuple(k.shape), str(q.dtype))

    def counts(self, phase="fwd"):
        return {k: self.calls[phase][k] for k in KEYS}

    def expect(self, phase="fwd"):
        return {k: self.admits[phase][k] for k in KEYS}


BF = torch.bfloat16


def assert_phase11_covers(sites):
    """chip_smoke.py's phase 11 checks every shape the switch path admitted
    (GN_SHAPES, LN_SHAPES, SKV_SHAPES)."""
    missing = sorted((key, *shape) for key, *shape in sites.shapes
                     if tuple(shape) not in CS.switch_site_shapes(key))
    assert not missing, missing


@pytest.mark.parametrize("config", ["mdm512", "mdm1024"])
def test_switch_sites_match_jax_predicates(monkeypatch, config):
    """One full-width UNet forward (batch 2, 16 frames, bf16) on the meta
    device: with both switches the kernel-11/12 wrappers are called at
    exactly the dispatch-point calls the JAX predicates admit, the counts
    chip_smoke.py holds its phase-12 launches to; with the switches unset,
    at none."""
    h, w = CS.LATENT[config]
    for switches in (True, False):
        with monkeypatch.context() as mp:
            sites = Sites(mp, switches)
            with torch.device("meta"), torch.no_grad():
                unet = TU.UNet3D(TU.UNetConfig()).to(BF)
                x = torch.empty(2, 16, h, w, 12, dtype=BF)
                ctx = torch.empty(2, 77 + 256, 1024, dtype=BF)
                ts = torch.zeros(2, dtype=torch.int64)
                unet(x, ts, ctx, c_label=ts)
            if switches:
                assert sites.counts() == sites.expect()
                assert sites.counts() == CS.SWITCH_SITES[config]
                assert_phase11_covers(sites)
            else:
                assert sum(sites.counts().values()) == 0


@pytest.mark.parametrize("config", ["mdm512", "mdm1024"])
def test_switch_sites_f32_forward(monkeypatch, config):
    """One full-width fp32 UNet forward (batch 2, impl="auto") on the meta
    device with both switches: kernels 11 and 12 take fp32, as the Pallas
    kernels take any dtype, so the wrappers are called at exactly the calls
    the JAX predicates admit (fewer GN sites than in bf16: the fp32 budget
    is 1,048,576 elements per sample), chip_smoke.py's SWITCH_SITES_F32, at
    shapes phase 11 checks in fp32."""
    h, w = CS.LATENT[config]
    sites = Sites(monkeypatch)
    with torch.device("meta"), torch.no_grad():
        unet = TU.UNet3D(TU.UNetConfig())
        x = torch.empty(2, 16, h, w, 12)
        ctx = torch.empty(2, 77 + 256, 1024)
        ts = torch.zeros(2, dtype=torch.int64)
        unet(x, ts, ctx, c_label=ts)
    assert sites.counts() == sites.expect() == {k: CS.SWITCH_SITES_F32[config][k] for k in KEYS}
    assert_phase11_covers(sites)


# the wrapper calls of one encode + one decode pass of the VAE over a chunk of
# frames, by frame size and dtype: only the 40x64x512 level of the 320x512
# VAE fits (in bf16)
_NONE = {"group_norm": 0, "layer_norm": 0, "short_kv_attention": 0}
SWITCH_VAE = {(320, 512, BF): {**_NONE, "group_norm": 21}, (576, 1024, BF): _NONE,
              (320, 512, torch.float32): _NONE, (576, 1024, torch.float32): _NONE}


def _meta_mdm(cfg):
    with torch.device("meta"):
        mdm = TMDM.MDM(cfg)
    return mdm


def test_switch_sites_vae_resampler_towers(monkeypatch):
    """The VAE (encode and decode at 320x512 and at 576x1024, bf16 and fp32),
    the resampler and both CLIP towers on the meta device: the wrappers are
    called at exactly the calls the JAX predicates admit. Only the VAE's
    40x64x512 level and the resampler's latents fit; the towers' 77- and
    257-token rows have no row block of 8."""
    sites = Sites(monkeypatch)
    cfg = TMDM.MDMConfig()
    mdm = _meta_mdm(cfg)
    with torch.device("meta"), torch.no_grad():
        for dt in (BF, torch.float32):
            vae = mdm.vae.to(dt)
            for hw in ((320, 512), (576, 1024)):
                before = dict(sites.counts())
                z = TV.encode_video(vae, torch.empty(1, 2, *hw, 3, dtype=dt), chunk=2)
                TV.decode_video(vae, z, chunk=2)
                got = {k: sites.counts()[k] - before[k] for k in KEYS}
                # one encode and one decode pass over a chunk of two frames
                assert got == SWITCH_VAE[(*hw, dt)], (hw, dt, got)
        mdm.image_proj.to(BF)(torch.empty(2, 257, 1280, dtype=BF))
        mdm.clip_text.to(BF)
        TMDM.encode_text(mdm, torch.zeros(2, 77, dtype=torch.int64))
        mdm.clip_image.to(BF)(torch.empty(2, 224, 224, 3, dtype=BF))
    assert sites.counts() == sites.expect()
    assert sites.counts()["group_norm"] > 0 and sites.counts()["layer_norm"] > 0


def test_switch_sites_sample_components(monkeypatch):
    """The MDM1024 clip's sites outside its 25 UNet forwards: the VAE encode
    of the stacked sparse RGB and depth videos and the decode at 576x1024
    (none fit), the text tower (none) and the image tower + resampler of the
    image and its null (the resampler's latents): chip_smoke.py's
    SWITCH_CLIP_EXTRA, at shapes its phase 11 checks."""
    sites = Sites(monkeypatch)
    cfg = TP.mdm1024()
    mdm = _meta_mdm(cfg)
    for sub in (mdm.vae, mdm.image_proj, mdm.clip_text, mdm.clip_image):
        sub.to(BF)
    with torch.device("meta"), torch.no_grad():
        video = torch.empty(1, 16, 576, 1024, 3, dtype=BF)
        TMDM.encode_conditions(mdm, video, video)
        TV.decode_video(mdm.vae, torch.empty(1, 16, 72, 128, 4, dtype=BF), chunk=cfg.vae_chunk)
        TMDM.encode_text(mdm, torch.zeros(1, 77, dtype=torch.int64))
        TMDM.encode_text(mdm, torch.zeros(1, 77, dtype=torch.int64))
        TMDM.embed_image(mdm, torch.empty(2, 576, 1024, 3, dtype=BF))
    assert sites.counts() == sites.expect() == CS.SWITCH_CLIP_EXTRA
    assert_phase11_covers(sites)


def test_switch_sites_training_micro_step(monkeypatch):
    """One full-width MDM512 training micro-step (`training_loss` at batch 1,
    pixel form, remat, impl="train", fp32 masters) and its backward on the
    meta device: the wrappers are called at exactly the calls the JAX
    predicates admit in the forward (the VAE encode, the resampler and the
    UNet), and the backward's remat recompute calls them again at every
    checkpointed site: chip_smoke.py's SWITCH_TRAIN, at shapes its phase 11
    checks."""
    sites = Sites(monkeypatch)
    cfg = TMDM.MDMConfig()
    mdm = _meta_mdm(cfg)
    for k in ("vae", "clip_text", "clip_image"):
        getattr(mdm, k).to(BF).requires_grad_(False)
    with torch.device("meta"):
        video = torch.empty(1, 16, 320, 512, 3)
        batch = {"dense_frames": video, "sparse_frames": video, "sparse_depth": video,
                 "tokens": torch.zeros(1, 77, dtype=torch.int64),
                 "class_label": torch.zeros(1, dtype=torch.int64)}
        shapes = TMDM.training_shapes(cfg, batch)
        lat = shapes["latent"]
        draws = {"t": torch.zeros(1, dtype=torch.int64), "noise": torch.empty(lat),
                 "posterior_eps": torch.empty(shapes["posterior"]),
                 "cfg_uniform": torch.ones(1), "offset_noise": torch.empty(1, lat[1], 1, 1,
                                                                            lat[-1])}
        null_emb = torch.empty(1, 77, 1024, dtype=BF)
        with torch.enable_grad():
            loss, _ = TMDM.training_loss(mdm, batch, draws, null_emb=null_emb, impl="train",
                                         remat=True)
            sites.phase = "bwd"
            loss.backward()
    assert sites.counts("fwd") == sites.expect("fwd") == CS.SWITCH_TRAIN["fwd"]
    assert sites.counts("bwd") == sites.expect("bwd") == CS.SWITCH_TRAIN["bwd"]
    assert_phase11_covers(sites)


# ---------------------------------------------------------------------------
# The slice: the tiny UNet on the switch path against JAX
# ---------------------------------------------------------------------------

def test_tiny_unet_on_the_switch_path_matches_jax(monkeypatch):
    """The tiny-config UNet of tests/test_torch_model.py with both switches
    set and the CUDA check taken as true, so that every site the predicates
    admit goes through the kernel-11/12 wrappers (their plain versions on the
    CPU), against the JAX UNet on the same weights and inputs, within the
    slice tolerance (tests/test_reference_oracle.py:46-53). T = 16 frames of
    16x16 make the spatial cross-attention's 256 queries eligible for the
    short-KV kernel."""
    sites = Sites(monkeypatch)
    cfg = dict(TINY_UNET, temporal_length=16, num_head_channels=64, model_channels=64,
               context_dim=16)
    key = jax.random.PRNGKey(0)
    tree = random_tree(jax.eval_shape(lambda: JU.init_unet(key, JU.UNetConfig(**cfg))), 11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 16, 16, 16, 12)).astype(np.float32)
    ctx = rng.standard_normal((1, 77 + 16 * 16, 16)).astype(np.float32)
    ts = np.array([421], np.int64)
    ref = JU.unet_apply(to_jax(tree), JU.UNetConfig(**cfg), jnp.asarray(x),
                        jnp.asarray(ts, jnp.int32), jnp.asarray(ctx),
                        c_label=jnp.asarray(ts * 0, jnp.int32))
    unet = port(TU.UNet3D(TU.UNetConfig(**cfg)), tree)
    with torch.no_grad():
        ours = unet(t(x), t(ts), t(ctx), c_label=t(ts * 0))
    counts = sites.counts()
    assert counts == sites.expect() and all(v > 0 for v in counts.values()), counts
    assert_close(ours, ref, SLICE_TOL, SLICE_ATOL, "unet on the switch path")
