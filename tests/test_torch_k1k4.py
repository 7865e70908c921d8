"""The algebra of kernels 1 and 4's Hopper designs, in plain torch on the CPU,
held against the JAX package.

Kernel 4 (`csrc/tconv.cu`) runs three steps: GroupNorm statistics per (clip,
group) with the centered variance, h = silu(GN(x)) in fp32 rounded to bf16
once, then per frame the zero-padded three-tap GEMM [h_{t-1} | h_t |
h_{t+1}] wcat^T + bias. `_tconv_steps` is those steps; it is held against
`mudg_tpu.kernels.tconv._xla_math` (at H*W = 135, no multiple of the
kernel's 128-row tile, and C = 96, no multiple of its 64-column K slab) and
against the Pallas kernel in interpret mode (which takes H*W % 64 == 0
only), and at a DC offset of 1e3 against float64.

Kernel 1 (`csrc/spatial_attn.cu`) runs LN -> q|k|v -> the flash core with
qscale = 1 on the packed Wq' (the softmax scale and log2(e) folded in) ->
out-projection + bias + x. `_spatial_steps` is that algebra; it is held
against the Pallas `fused_self_attention` in interpret mode at L % 128 == 64
(the core's last 128-row block half empty), and the scale applied twice
(kernel 5's qscale reused on the folded Wq') must miss the tolerance.
Tolerance: max|diff| <= 3e-2 * max|ref|, as the JAX kernel tests.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mudg_tpu.kernels import spatial_attn as JSP
from mudg_tpu.kernels import tconv as JTC
from mudg_tpu_torch.kernels import spatial_attn as SP
from mudg_tpu_torch.kernels import tconv as TC
from test_torch_kernels import _attn, _norm_tree, _tconv, _x
from test_torch_util import assert_close, port, t, to_jax

KERNEL_TOL = 3e-2
LOG2E = 1.4426950408889634


def _bf16(v):
    return v.to(torch.bfloat16).float()


# ------------------------------------------------------------------ kernel 4

def _tconv_steps(x, packed, groups=32, eps=1e-5, one_pass=False):
    """Kernel 4's three steps on x (B, T, H, W, C), in fp32 (float64 for a
    float64 x). `one_pass` takes E[x^2] - E[x]^2 for the variance (a
    planted fault)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    b, fr, hh, ww, c = xf.shape
    # 1. statistics per (clip, group) over (T*H*W, C / groups)
    xg = xf.reshape(b, -1, groups, c // groups)
    mean = xg.mean((1, 3), keepdim=True)
    if one_pass:
        var = (xg * xg).mean((1, 3), keepdim=True) - mean * mean
    else:
        var = ((xg - mean) ** 2).mean((1, 3), keepdim=True)
    # 2. h = silu(GN(x)), one rounding to bf16
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(xf.shape)
    y = y * packed.gn_w.to(dt) + packed.gn_b.to(dt)
    h = (y * torch.sigmoid(y)).to(torch.bfloat16).to(dt)
    # 3. per frame, the zero-padded taps by wcat
    h = h.reshape(b, fr, hh * ww, c)
    hp = torch.nn.functional.pad(h, (0, 0, 0, 0, 1, 1))       # a zero frame at each end
    cat = torch.cat([hp[:, :-2], hp[:, 1:-1], hp[:, 2:]], -1)  # tap 0 is t - 1
    out = cat @ packed.wcat.to(dt).T + packed.bias.to(dt)
    return out.reshape(b, fr, hh, ww, c)


def _tconv_case(shape, seed):
    c = shape[-1]
    p_gn, p_conv, norm, conv = _tconv(c, seed)
    xb = (_x(shape, seed + 1) * 2 + 1).astype(np.float32)
    xb = np.asarray(jnp.asarray(xb).astype(jnp.bfloat16), np.float32)   # bf16 values
    return p_gn, p_conv, TC.pack_tconv(conv, norm), xb, norm, conv


@pytest.mark.parametrize("shape", [(2, 3, 9, 15, 96), (1, 4, 8, 16, 64)])
def test_tconv_steps_match_xla_math(shape):
    p_gn, p_conv, packed, xb, norm, conv = _tconv_case(shape, 40)
    ref = JTC._xla_math(jnp.asarray(xb), to_jax(p_gn), to_jax(p_conv))
    with torch.no_grad():
        ours = _tconv_steps(t(xb), packed)
        assert_close(ours, ref, KERNEL_TOL)
        # the taps in the wrong order are seen
        wrong = packed._replace(wcat=packed.wcat.reshape(shape[-1], 3, -1).flip(1)
                                .reshape(shape[-1], -1))
        with pytest.raises(AssertionError):
            assert_close(_tconv_steps(t(xb), wrong), ref, KERNEL_TOL)


@pytest.mark.parametrize("shape", [(1, 4, 8, 16, 64), (2, 3, 8, 8, 96)])
def test_tconv_steps_match_pallas_interpret(shape):
    """The Pallas kernel (interpret mode) takes H*W % 64 == 0 only; C = 96
    leaves the kernel's last K slab of each tap half empty."""
    p_gn, p_conv, packed, xb, _, _ = _tconv_case(shape, 42)
    ref = JTC.fused_gn_silu_tconv(jnp.asarray(xb).astype(jnp.bfloat16), to_jax(p_gn),
                                  to_jax(p_conv))
    with torch.no_grad():
        ours = _tconv_steps(t(xb), packed)
    assert_close(ours, np.asarray(ref, np.float32), KERNEL_TOL)


def test_tconv_steps_statistics_match_gn_fold():
    """Step 1's statistics fold to the JAX gn_fold's per-(B, C) scale and
    shift (and to the port's plain copy of it)."""
    shape = (2, 3, 9, 15, 96)
    p_gn, _, packed, xb, norm, _ = _tconv_case(shape, 44)
    x = t(xb)
    xg = x.reshape(2, -1, 32, 3)
    mean = xg.mean((1, 3))
    rstd = torch.rsqrt(((xg - mean[:, None, :, None]) ** 2).mean((1, 3)) + 1e-5)
    scale = rstd.repeat_interleave(3, -1) * packed.gn_w
    shift = packed.gn_b - mean.repeat_interleave(3, -1) * scale
    ref_sc, ref_sh = JTC.gn_fold(to_jax(p_gn), jnp.asarray(xb))
    assert_close(scale, ref_sc, 1e-5, 1e-6)
    assert_close(shift, ref_sh, 1e-5, 1e-6)
    sc, sh = TC.gn_fold(norm, x)
    assert_close(sc, ref_sc, 1e-5, 1e-6)
    assert_close(sh, ref_sh, 1e-5, 1e-6)


def test_tconv_steps_at_a_dc_offset():
    """At a DC offset of 1e3 with groups that vary little (1e3 + 4 s, P(s =
    +-1) = 1/128 each, bf16 values) the centered statistics stay within the
    tolerance of the float64 steps; the one-pass variance misses it (or goes
    negative)."""
    shape = (2, 4, 16, 16, 64)
    _, _, packed, _, _, _ = _tconv_case(shape, 46)
    u = np.random.default_rng(47).random(shape)
    x = t((1e3 + 4.0 * ((u < 1 / 128).astype(np.float32) - (u > 1 - 1 / 128))).astype(
        np.float32))
    with torch.no_grad():
        ref = _tconv_steps(x.double(), packed)
        assert_close(_tconv_steps(x, packed), ref.float(), KERNEL_TOL)
        bad = _tconv_steps(x, packed, one_pass=True).double()
    err = (bad - ref).abs().nan_to_num(float("inf")).max().item()
    assert err > KERNEL_TOL * ref.abs().max().item()


# ------------------------------------------------------------------ kernel 1

def _spatial_steps(x, packed, heads, qscale=1.0):
    """Kernel 1's four launches on x (B, L, C) bf16 values in fp32: LN to
    bf16, q|k|v = xn Wqkv^T to bf16, the flash core (q * qscale rounded to
    bf16, base-2 softmax in fp32, P rounded to bf16, o = P V / l to bf16),
    out = o Wo^T + bo + x."""
    b, l, c = x.shape
    mu = x.mean(-1, keepdim=True)
    xn = _bf16((x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
               * packed.ln_w + packed.ln_b)
    qkv = _bf16(xn @ packed.wqkv.float().T)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, l, heads, 64) for i in range(3))
    q = _bf16(q * qscale)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", _bf16(p), v) / p.sum(-1).transpose(1, 2)[..., None]
    o = _bf16(o).reshape(b, l, c)
    return x + o @ packed.wo.float().T + packed.bo


@pytest.mark.parametrize("heads,c,l", [(2, 128, 192)])
def test_spatial_core_qscale_one_matches_pallas_interpret(heads, c, l):
    p_attn, attn = _attn(c, heads, 50)
    p_norm = _norm_tree(c, 51)
    norm = port(nn.LayerNorm(c), p_norm)
    packed = SP.pack_stage(norm, attn, heads)
    xb = jnp.asarray(_x((2, l, c), 52)).astype(jnp.bfloat16)
    ref = np.asarray(JSP._fused_impl(xb, to_jax(p_norm), to_jax(p_attn), heads=heads),
                     np.float32)
    x = t(np.asarray(xb, np.float32))
    with torch.no_grad():
        # q times 1.0 in fp32 rounds back to itself: the core adds no rounding
        q = packed.wqkv[:c].float()
        assert torch.equal(_bf16(q * 1.0), q)
        ours = _spatial_steps(x, packed, heads)
        assert_close(ours - x, ref - np.asarray(x), KERNEL_TOL)
        ours_xla = np.asarray(JSP._xla_impl(jnp.asarray(x.numpy()), to_jax(p_norm),
                                            to_jax(p_attn), heads=heads))
        assert_close(ours - x, ours_xla - x.numpy(), KERNEL_TOL)
        twice = _spatial_steps(x, packed, heads, qscale=0.125 * LOG2E)
    with pytest.raises(AssertionError):
        assert_close(twice - x, ref - np.asarray(x), KERNEL_TOL)
