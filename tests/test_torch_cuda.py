"""The port's CUDA kernels on the card: each against its plain version, and a
small UNet whose every kernel site is eligible, kernel path against the fp32
plain path. Marked `cuda`; skipped without a GPU. These tests import no JAX,
so on a machine without it they run with the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
from __future__ import annotations

import copy
import math

import pytest
import torch
from torch import nn

pytestmark = pytest.mark.cuda
TOL = 3e-2   # max|diff| <= TOL * max|ref|, as the JAX kernel tests


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randomize(module, gen):
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            r = torch.randn(p.shape, generator=gen, device=p.device)
            if p.ndim >= 2:
                r /= math.sqrt(p[0].numel())
            elif name.endswith("weight"):
                r = 1 + 0.1 * r
            else:
                r *= 0.1
            p.copy_(r)
    return module


def _close(got, ref, base=None):
    """max|got - ref| <= TOL * max|ref|, on got - base and ref - base where
    the kernel adds the residual `base`: the residual's bf16 rounding would
    otherwise hide an error in the part the kernel computes. Returns the
    part of ref held, for a planted-fault check."""
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    got, ref = got.float(), ref.float()
    if base is not None:
        got, ref = got - base.float(), ref - base.float()
    err = (got - ref).abs().max().item()
    assert err <= TOL * ref.abs().max().item(), err
    return ref


def _mods(dev, gen, *ms):
    return [_randomize(m.to(dev, torch.bfloat16), gen) for m in ms]


def _sharpen(*attns):
    """Logits ~N(0, 9), as chip_smoke.py: a peaked softmax with an O(1)
    attention term, which a near-uniform one over long L is not."""
    with torch.no_grad():
        for a in attns:
            a.to_q.weight.mul_(3 ** 0.5)
            a.to_k.weight.mul_(3 ** 0.5)


def _zero_v(attn):
    """A copy of attn with zero attention term (a planted fault)."""
    z = copy.deepcopy(attn)
    with torch.no_grad():
        z.to_v.weight.zero_()
    return z


def _sees(fault, ref_part, base):
    """The planted fault's output misses the tolerance _close holds."""
    err = (fault.float() - base.float() - ref_part).abs().max().item()
    assert err > TOL * ref_part.abs().max().item(), err


def test_spatial_attn_kernel(dev):
    from mudg_tpu_torch.kernels import spatial_attn as SP
    from mudg_tpu_torch.nn.attention import CrossAttention

    gen = torch.Generator(device=dev).manual_seed(0)
    norm, attn = _mods(dev, gen, nn.LayerNorm(128), CrossAttention(128, heads=2, dim_head=64))
    _sharpen(attn)
    x = torch.randn(3, 192, 128, generator=gen, device=dev).bfloat16()
    before = SP.launches
    got = SP.fused_self_attention(x, norm, attn, 2, SP.pack_stage(norm, attn, 2))
    assert SP.launches == before + 1
    ref = _close(got, SP.plain_self_attention(x, norm, attn, 2), base=x)
    _sees(SP.plain_self_attention(x, norm, _zero_v(attn), 2), ref, x)


def test_temporal_attn_kernel(dev):
    from mudg_tpu_torch.kernels import spatial_attn as SP
    from mudg_tpu_torch.kernels import temporal_attn as TA
    from mudg_tpu_torch.nn.attention import CrossAttention

    gen = torch.Generator(device=dev).manual_seed(1)
    n1, a1, n2, a2 = _mods(dev, gen, nn.LayerNorm(128), CrossAttention(128, heads=2),
                           nn.LayerNorm(128), CrossAttention(128, heads=2))
    _sharpen(a1, a2)
    x = torch.randn(12, 16, 128, generator=gen, device=dev).bfloat16()
    packed = (SP.pack_stage(n1, a1, 2), SP.pack_stage(n2, a2, 2))
    got = TA.fused_double_self_attn(x, (n1, a1), (n2, a2), 2, packed)
    ref = _close(got, TA.plain_double_self_attn(x, (n1, a1), (n2, a2), 2), base=x)
    _sees(TA.plain_double_self_attn(x, (n1, _zero_v(a1)), (n2, _zero_v(a2)), 2), ref, x)


@pytest.mark.parametrize("block", [True, False])
def test_geglu_ff_kernel(dev, block):
    from mudg_tpu_torch.kernels import mlp as M
    from mudg_tpu_torch.nn.attention import FeedForward

    gen = torch.Generator(device=dev).manual_seed(2)
    norm, ff = _mods(dev, gen, nn.LayerNorm(96), FeedForward(96))   # inner 384
    x = torch.randn(2, 384, 96, generator=gen, device=dev).bfloat16()
    packed = M.pack_ff(ff, norm)
    if block:
        _close(M.fused_geglu_ff_block(x, norm, ff, packed), M.plain_geglu_ff_block(x, norm, ff),
               base=x)
    else:
        _close(M.fused_geglu_ff(x, ff, packed), M.plain_geglu_ff(x, ff))


def test_gn_silu_tconv_kernel(dev):
    from mudg_tpu_torch.kernels import tconv as TC

    gen = torch.Generator(device=dev).manual_seed(3)
    norm, conv = _mods(dev, gen, nn.GroupNorm(32, 64), nn.Conv3d(64, 64, (3, 1, 1)))
    x = (torch.randn(2, 5, 6, 10, 64, generator=gen, device=dev) * 2 + 1).bfloat16()
    _close(TC.fused_gn_silu_tconv(x, norm, conv, TC.pack_tconv(conv)),
           TC.plain_gn_silu_tconv(x, norm, conv))


@pytest.mark.parametrize("b,l,h", [(2, 192, 3), (1, 1024, 2)])
def test_flash_attention_kernel(dev, b, l, h):
    """Kernel 5 on strided q/k/v views of one packed (B, L, 3, H, 64)
    tensor, o and lse against the plain version."""
    from mudg_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(6)
    qkv = torch.randn(b, l, 3, h, 64, generator=gen, device=dev).bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    before = FA.launches
    o, lse = FA.flash_attention(q, k, v)
    assert FA.launches == before + 1
    o_ref, lse_ref = FA.plain_flash_attention(q, k, v)
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-2


@pytest.mark.parametrize("b,l,c", [(2, 2304, 640), (2, 9216, 320), (144, 9216, 320)])
def test_spatial_attn_kernel_long_l(dev, b, l, c):
    """Kernel 1 at the MDM1024 sequence lengths of TPU kernels 7 and 8; 144
    frames is a 3-task, 3-variant batch, whose q|k|v scratch holds 1.27e9
    elements."""
    from mudg_tpu_torch.kernels import spatial_attn as SP
    from mudg_tpu_torch.nn.attention import CrossAttention

    heads = c // 64
    gen = torch.Generator(device=dev).manual_seed(7)
    norm, attn = _mods(dev, gen, nn.LayerNorm(c), CrossAttention(c, heads=heads))
    _sharpen(attn)
    x = torch.randn(b, l, c, generator=gen, device=dev).bfloat16()
    with torch.no_grad():   # the plain version's chunks keep no autograd graph
        got = SP.fused_self_attention(x, norm, attn, heads, SP.pack_stage(norm, attn, heads))
        ref = _close(got, SP.plain_self_attention(x, norm, attn, heads), base=x)
        del got
        _sees(SP.plain_self_attention(x, norm, _zero_v(attn), heads), ref, x)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from mudg_tpu_torch.kernels import spatial_attn as SP
    from mudg_tpu_torch.nn.attention import CrossAttention

    gen = torch.Generator(device=dev).manual_seed(4)
    norm, attn = _mods(dev, gen, nn.LayerNorm(128), CrossAttention(128, heads=2))
    packed = SP.pack_stage(norm, attn, 2)
    with pytest.raises(ValueError):   # fp32 activations
        SP.fused_self_attention(torch.randn(1, 64, 128, device=dev), norm, attn, 2, packed)
    with pytest.raises(ValueError):   # L not a multiple of 64
        SP.fused_self_attention(torch.randn(1, 96, 128, device=dev).bfloat16(),
                                norm, attn, 2, packed)

    from mudg_tpu_torch.kernels import flash_attention as FA

    q = torch.randn(1, 128, 2, 64, device=dev).bfloat16()
    with pytest.raises(ValueError):   # head dim 32
        FA.flash_attention(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(ValueError):   # fp32
        FA.flash_attention(q.float(), q.float(), q.float())


def test_small_unet_kernel_path_matches_fp32(dev):
    """Every kernel site of a small UNet (C=64, d=64, T=16) is eligible; the
    bf16 kernel path must stay as close to the fp32 plain path as the bf16
    plain path does (1.5x + 5e-3 in relative L2, as chip_smoke.py)."""
    import mudg_tpu_torch.kernels as K
    from mudg_tpu_torch.nn import unet3d as U

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = U.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                       attention_resolutions=(1,), context_dim=32)
    gen = torch.Generator(device=dev).manual_seed(5)
    unet = _randomize(U.UNet3D(cfg).to(dev), gen).eval()
    x = torch.randn(1, 16, 8, 8, 12, generator=gen, device=dev)
    ctx = torch.randn(1, 77 + 256, 32, generator=gen, device=dev)
    ts = torch.tensor([500], device=dev)
    with torch.no_grad():
        ref = unet(x, ts, ctx, c_label=ts * 0)
        unet.bfloat16()
        K.prepare_kernels(unet)
        plain = unet(x.bfloat16(), ts, ctx.bfloat16(), c_label=ts * 0, impl="plain")
        K.reset_launch_counts()
        got = unet(x.bfloat16(), ts, ctx.bfloat16(), c_label=ts * 0)
    counts = K.launch_counts()
    # kernel 5 takes self-attention at L >= 512 wider than kernel 1's C <= 640:
    # no such site at this size
    assert counts.pop("flash_attention") == 0
    assert all(v > 0 for v in counts.values()), counts
    e_k = ((got.float() - ref).norm() / ref.norm()).item()
    e_p = ((plain.float() - ref).norm() / ref.norm()).item()
    assert e_k <= 1.5 * e_p + 5e-3, (e_k, e_p)
