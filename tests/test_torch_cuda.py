"""The port's CUDA kernels on the card: each against its plain version, the
backward kernels (6, 9, 10) against their plain backward versions and, through
their autograd ops, against autograd of the plain forward in fp32; a small
UNet whose every kernel site is eligible, kernel path against the fp32 plain
path; the training ops reading the current weights. Marked `cuda`; skipped
without a GPU. These tests import no JAX, so on a machine without it they
run with the repository's conftest left out:

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
BWD_TOL = 5e-2   # each gradient, as the JAX gradient tests (tests/test_attention.py:274-280)


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
    # no such site at this size; the backward kernels run only in training
    assert counts.pop("flash_attention") == 0
    for name in [n for n in counts if n.endswith("_bwd")]:
        assert counts.pop(name) == 0
    assert all(v > 0 for v in counts.values()), counts
    e_k = ((got.float() - ref).norm() / ref.norm()).item()
    e_p = ((plain.float() - ref).norm() / ref.norm()).item()
    assert e_k <= 1.5 * e_p + 5e-3, (e_k, e_p)


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------

def _grads_close(got, ref, tol=BWD_TOL):
    """Each gradient within max|diff| <= tol * max|its ref|; returns the
    largest ratio."""
    torch.cuda.synchronize()
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.isfinite(g).all(), i
        ratio = (g.float() - r.float()).abs().max().item() / r.float().abs().max().item()
        assert ratio <= tol, (i, ratio)
        worst = max(worst, ratio)
    return worst


def _grads_miss(fault, ref, tol=BWD_TOL):
    """A planted fault misses the tolerance on some gradient."""
    ratios = [(f.float() - r.float()).abs().max().item() / r.float().abs().max().item()
              for f, r in zip(fault, ref)]
    assert max(ratios) > tol, ratios


def _bit_equal(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("b,l,h", [(2, 192, 3), (1, 1024, 2)])
def test_flash_attention_bwd_kernel(dev, b, l, h):
    """Kernel 6 against the plain FA-2 backward on strided q/k/v, with the
    planted faults of chip_smoke.py (delta dropped, half the keys); two runs
    agree bit for bit (every gradient is written by one block, no atomics)."""
    from mudg_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(8)
    qkv = torch.randn(b, l, 3, h, 64, generator=gen, device=dev).bfloat16()
    q, k, v = qkv.unbind(2)
    do = torch.randn(b, l, h, 64, generator=gen, device=dev).bfloat16()
    o, lse = FA.flash_attention(q, k, v)
    before = FA.bwd_launches
    got = FA.flash_attention_bwd(q, k, v, o, lse, do)
    assert FA.bwd_launches == before + 1
    ref = FA.plain_flash_attention_bwd(q, k, v, o, lse, do)
    _grads_close(got, ref)
    _bit_equal(got, FA.flash_attention_bwd(q, k, v, o, lse, do))
    _grads_miss(FA.plain_flash_attention_bwd(q, k, v, o, lse, do, delta=torch.zeros_like(lse)),
                ref)
    half = l // 2
    dq, dk, dv = FA.plain_flash_attention_bwd(q, k[:, :half], v[:, :half], o, lse, do)
    pad = (0, 0, 0, 0, 0, l - half)
    _grads_miss((dq, torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad)), ref)


def test_flash_attention_train_grads_match_fp32_autograd(dev):
    """The autograd op (kernel 5 forward, kernel 6 backward) against autograd
    through the plain attention in fp32 on the same bf16 inputs."""
    from mudg_tpu_torch.kernels import flash_attention as FA
    from mudg_tpu_torch.nn.attention import plain_attend

    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(2, 256, 2, 64, generator=gen, device=dev).bfloat16()
               .requires_grad_() for _ in range(3))
    do = torch.randn(2, 256, 2, 64, generator=gen, device=dev).bfloat16()
    before = (FA.launches, FA.bwd_launches)
    got = torch.autograd.grad(FA.flash_attention_train(q, k, v), (q, k, v), do)
    assert (FA.launches, FA.bwd_launches) == (before[0] + 1, before[1] + 1)
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    ref = torch.autograd.grad(plain_attend(qf, kf, vf), (qf, kf, vf), do.float())
    _grads_close(got, ref)


def _temporal_setup(dev, seed, c=128):
    from mudg_tpu_torch.kernels import temporal_attn as TA
    from mudg_tpu_torch.nn.attention import CrossAttention

    heads = c // 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    mods = [_randomize(m.to(dev), gen) for m in (nn.LayerNorm(c), CrossAttention(c, heads=heads),
                                                 nn.LayerNorm(c), CrossAttention(c, heads=heads))]
    _sharpen(mods[1], mods[3])
    x = torch.randn(12, 16, c, generator=gen, device=dev).bfloat16()
    dy = torch.randn(12, 16, c, generator=gen, device=dev).bfloat16()
    return TA, mods, heads, x, dy


def _flat(out):
    dx, g1, g2 = out
    return (dx, *g1, *g2)


def test_temporal_attn_bwd_kernel(dev):
    """Kernel 9 (both stages, fp32 parameters) against the plain per-stage
    backward, the planted fault (the softmax Jacobian's row-sum term
    dropped) missing; two runs agree bit for bit (fixed-order split sums)."""
    TA, (n1, a1, n2, a2), heads, x, dy = _temporal_setup(dev, 10)
    p1, p2 = TA.stage_params(n1, a1), TA.stage_params(n2, a2)
    with torch.no_grad():
        h1 = TA.plain_stage(x, p1, heads)
        before = TA.bwd_launches
        got = _flat(TA.double_self_attn_bwd(x, h1, dy, p1, p2, heads))
        assert TA.bwd_launches == before + 1
        dh1, g2 = TA.plain_temporal_stage_bwd(h1, dy, p2, heads)
        dx, g1 = TA.plain_temporal_stage_bwd(x, dh1, p1, heads)
        ref = _flat((dx, g1, g2))
        _grads_close(got, ref)
        _bit_equal(got, _flat(TA.double_self_attn_bwd(x, h1, dy, p1, p2, heads)))
        fh1, fg2 = TA.plain_temporal_stage_bwd(h1, dy, p2, heads, drop_rowsum=True)
        fdx, fg1 = TA.plain_temporal_stage_bwd(x, fh1, p1, heads, drop_rowsum=True)
        _grads_miss(_flat((fdx, fg1, fg2)), ref)


def test_temporal_attn_train_grads_match_fp32_autograd(dev):
    """The autograd op (kernel 2 forward with h1, kernel 9 backward) against
    autograd through the plain double stage in fp32, gradients to the tokens
    and every parameter of both stages."""
    TA, (n1, a1, n2, a2), heads, x, dy = _temporal_setup(dev, 11)
    xg = x.clone().requires_grad_()
    params = [*TA.stage_params(n1, a1), *TA.stage_params(n2, a2)]
    before = (TA.launches, TA.bwd_launches)
    y = TA.double_self_attn_train(xg, (n1, a1), (n2, a2), heads)
    got = torch.autograd.grad(y, [xg, *params], dy)
    assert (TA.launches, TA.bwd_launches) == (before[0] + 1, before[1] + 1)
    xf = x.float().requires_grad_()
    yf = TA.plain_stage(TA.plain_stage(xf, params[:7], heads), params[7:], heads)
    ref = torch.autograd.grad(yf, [xf, *params], dy.float())
    _grads_close(got, ref)


def _ff_setup(dev, seed):
    from mudg_tpu_torch.kernels import mlp as M
    from mudg_tpu_torch.nn.attention import FeedForward

    gen = torch.Generator(device=dev).manual_seed(seed)
    norm, ff = (_randomize(m.to(dev), gen) for m in (nn.LayerNorm(96), FeedForward(96)))
    x = torch.randn(2, 384, 96, generator=gen, device=dev).bfloat16()   # inner 384
    dy = torch.randn(2, 384, 96, generator=gen, device=dev).bfloat16()
    return M, norm, ff, x, dy


def test_geglu_ff_bwd_kernel(dev):
    """Kernel 10 against the plain GEGLU backward (fp32 weight gradients),
    the planted fault (the g * pdf(g) term dropped) missing; two runs agree
    bit for bit."""
    M, _, ff, x, dy = _ff_setup(dev, 12)
    w1, b1, w2, _ = M.ff_params(ff)
    with torch.no_grad():
        before = M.bwd_launches
        got = M.geglu_ff_bwd(x, dy, w1, b1, w2)
        assert M.bwd_launches == before + 1
        ref = M.plain_geglu_ff_bwd(x, dy, w1, b1, w2)
        _grads_close(got, ref)
        _bit_equal(got, M.geglu_ff_bwd(x, dy, w1, b1, w2))
        _grads_miss(M.plain_geglu_ff_bwd(x, dy, w1, b1, w2, drop_pdf_term=True), ref)


@pytest.mark.parametrize("block", [True, False])
def test_geglu_ff_train_grads_match_fp32_autograd(dev, block):
    """The autograd ops (kernel 3 forward, kernel 10 backward; the block form
    with the LN's and the residual's backward in torch) against autograd
    through the plain FF in fp32."""
    M, norm, ff, x, dy = _ff_setup(dev, 13)
    xg = x.clone().requires_grad_()
    params = ([norm.weight, norm.bias] if block else []) + list(M.ff_params(ff))
    before = (M.launches, M.bwd_launches)
    y = M.geglu_ff_block_train(xg, norm, ff) if block else M.geglu_ff_train(xg, ff)
    got = torch.autograd.grad(y, [xg, *params], dy)
    assert (M.launches, M.bwd_launches) == (before[0] + 1, before[1] + 1)
    xf = x.float().requires_grad_()
    yf = M.plain_geglu_ff_block(xf, norm, ff) if block else M.plain_geglu_ff(xf, ff)
    ref = torch.autograd.grad(yf, [xf, *params], dy.float())
    _grads_close(got, ref)


def test_training_ops_read_current_weights(dev):
    """The training ops pack the fp32 parameters in every call: after a
    weight changes, the next training forward sees it, though the inference
    packs (prepare_kernels) still hold the old weights."""
    import mudg_tpu_torch.kernels as K
    from mudg_tpu_torch.nn.attention import BasicTransformerBlock

    gen = torch.Generator(device=dev).manual_seed(14)
    blk = _randomize(BasicTransformerBlock(128, heads=2, dim_head=64).to(dev), gen)
    x = torch.randn(1, 512, 128, generator=gen, device=dev).bfloat16()
    K.prepare_kernels(blk)
    y0 = blk(x, None, impl="train")
    with torch.no_grad():
        blk.ff.net["2"].weight.mul_(2.0)
        blk.attn1.to_v.weight.mul_(-1.0)
    y1 = blk(x, None, impl="train")
    with torch.no_grad():
        ref = blk(x, None, impl="plain")
    assert (y1.float() - y0.float()).abs().max().item() > 0.1
    torch.cuda.synchronize()
    part = (ref.float() - x.float()).abs().max().item()
    assert (y1.float() - ref.float()).abs().max().item() <= TOL * part
