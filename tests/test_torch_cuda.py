"""The port's CUDA kernels on the card: each against its plain version, the
backward kernels (6, 9, 10) against their plain backward versions and, through
their autograd ops, against autograd of the plain forward in fp32; a small
UNet whose every kernel site is eligible, kernel path against the fp32 plain
path, with and without MUDG_FUSED_NORMS=1 / MUDG_SHORT_ATTN=1; the training
ops reading the current weights; kernels 11 and 12 (norms, short attention)
in both dtypes where they take fp32 (GN, LN, short-KV), a GN rerun bit for
bit, each wrapper raising on what its kernel does not take, the small
UNet's fp32 forward on the switch path against its fp32 plain path, and
kernel 13 (3DGS compositing) on scenes, on tiles built to reach its
schedule, stages and saturation exits at every payload width edge, and
its tile sort alone. Marked `cuda`; skipped
without a GPU. These tests import no JAX, so on a machine without it they
run with the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
from __future__ import annotations

import copy
import math

import numpy as np
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
    from mudg_tpu_torch.kernels import temporal_attn as TA
    from mudg_tpu_torch.nn.attention import CrossAttention

    gen = torch.Generator(device=dev).manual_seed(1)
    n1, a1, n2, a2 = _mods(dev, gen, nn.LayerNorm(128), CrossAttention(128, heads=2),
                           nn.LayerNorm(128), CrossAttention(128, heads=2))
    _sharpen(a1, a2)
    x = torch.randn(12, 16, 128, generator=gen, device=dev).bfloat16()
    packed = (TA.pack_stage(n1, a1, 2), TA.pack_stage(n2, a2, 2))
    got = TA.fused_double_self_attn(x, (n1, a1), (n2, a2), 2, packed)
    ref = _close(got, TA.plain_double_self_attn(x, (n1, a1), (n2, a2), 2), base=x)
    _sees(TA.plain_double_self_attn(x, (n1, _zero_v(a1)), (n2, _zero_v(a2)), 2), ref, x)


def _swap_k_heads(attn):
    """A copy of attn with heads 0 and 1's key projections swapped, as from
    kernel 2 reading a mis-packed head order (a planted fault)."""
    z = copy.deepcopy(attn)
    with torch.no_grad():
        w = attn.to_k.weight
        z.to_k.weight.copy_(torch.cat([w[64:128], w[:64], w[128:]]))
    return z


@pytest.mark.parametrize("n,c", [(512, 320), (512, 512), (512, 640), (516, 320), (82944, 320)])
def test_temporal_attn_kernel_shapes(dev, n, c):
    """Kernel 2 at the UNet's widths (C = 320, 512, 640); at n = 516
    sequences (rows % 128 == 64: the last 128-row block half empty); and at
    ds1 of a 3-task, 3-variant MDM1024 batch, 9 x 9216 sequences (1.33e6
    rows). Mis-packed heads (heads 0 and 1's keys swapped) miss the
    tolerance."""
    from mudg_tpu_torch.kernels import temporal_attn as TA
    from mudg_tpu_torch.nn.attention import CrossAttention

    heads = c // 64
    gen = torch.Generator(device=dev).manual_seed(21)
    n1, a1, n2, a2 = _mods(dev, gen, nn.LayerNorm(c), CrossAttention(c, heads=heads),
                           nn.LayerNorm(c), CrossAttention(c, heads=heads))
    _sharpen(a1, a2)
    x = torch.randn(n, 16, c, generator=gen, device=dev).bfloat16()
    packed = (TA.pack_stage(n1, a1, heads), TA.pack_stage(n2, a2, heads))
    with torch.no_grad():   # the plain versions keep no autograd graph
        before = TA.launches
        got = TA.fused_double_self_attn(x, (n1, a1), (n2, a2), heads, packed)
        assert TA.launches == before + 1
        ref = _close(got, TA.plain_double_self_attn(x, (n1, a1), (n2, a2), heads), base=x)
        del got
        _sees(TA.plain_double_self_attn(x, (n1, _swap_k_heads(a1)), (n2, _swap_k_heads(a2)),
                                        heads), ref, x)


@pytest.mark.parametrize("rows", [256, 768, 200, 384])
@pytest.mark.parametrize("c", [96, 320, 640, 1280])
@pytest.mark.parametrize("block", [True, False])
def test_geglu_ff_kernel(dev, block, c, rows):
    """Kernel 3 in both forms at C in {96, 320, 640, 1280}, inner = 4C (C =
    96 and 320 leave the last 128-column block of the output GEMM partly
    empty, C = 96 also the last 64-wide K slab of the first). rows = 200 is
    not a multiple of the 128-row tile and rows = 384 an odd number of
    them (the dispatch predicate admits only rows % 256 == 0, the wrappers
    and the kernel any row count).
    A planted fault (the gate's bias dropped in the bare form, the residual
    dropped in the block form) misses the tolerance; a rerun gives the same
    bits."""
    from mudg_tpu_torch.kernels import mlp as M
    from mudg_tpu_torch.nn.attention import FeedForward

    gen = torch.Generator(device=dev).manual_seed(2)
    norm, ff = _mods(dev, gen, nn.LayerNorm(c), FeedForward(c))
    with torch.no_grad():   # a gate bias of O(1), so that dropping it shows
        ff.net["0"].proj.bias[4 * c:].add_(1.0)
    x = torch.randn(rows, c, generator=gen, device=dev).bfloat16()
    packed = M.pack_ff(ff, norm)
    before = M.launches
    if block:
        def run():
            return M.fused_geglu_ff_block(x, norm, ff, packed)
    else:
        def run():
            return M.fused_geglu_ff(x, ff, packed)
    got = run()
    assert M.launches == before + 1
    if block:
        ref = _close(got, M.plain_geglu_ff_block(x, norm, ff), base=x)
        _sees(M.plain_geglu_ff(M._layer_norm(x, norm.weight, norm.bias), ff), ref, x)
    else:
        ref = _close(got, M.plain_geglu_ff(x, ff))
        no_gate_bias = copy.deepcopy(ff)
        with torch.no_grad():
            no_gate_bias.net["0"].proj.bias[4 * c:].zero_()
        _sees(M.plain_geglu_ff(x, no_gate_bias), ref, torch.zeros_like(x))
    assert torch.equal(got, run())


def test_gn_silu_tconv_kernel(dev):
    from mudg_tpu_torch.kernels import tconv as TC

    gen = torch.Generator(device=dev).manual_seed(3)
    norm, conv = _mods(dev, gen, nn.GroupNorm(32, 64), nn.Conv3d(64, 64, (3, 1, 1)))
    x = (torch.randn(2, 5, 6, 10, 64, generator=gen, device=dev) * 2 + 1).bfloat16()
    _close(TC.fused_gn_silu_tconv(x, norm, conv, TC.pack_tconv(conv, norm)),
           TC.plain_gn_silu_tconv(x, norm, conv))


def _taps_reversed(conv):
    z = copy.deepcopy(conv)
    with torch.no_grad():
        z.weight.copy_(conv.weight.flip(2))
    return z


@pytest.mark.parametrize("shape", [(2, 2, 9, 15, 96), (1, 16, 40, 64, 320), (3, 2, 8, 16, 320),
                                   (2, 3, 16, 16, 608)])
def test_gn_silu_tconv_kernel_shapes(dev, shape):
    """Kernel 4 (GN statistics, h = silu(GN(x)), the three-tap TMA + wgmma
    GEMM) at H*W = 135 (no multiple of the 128-row tile) with C = 96 (a
    tap's last K slab half empty), at the MDM512 ds1 frame, at T = 2 (every
    frame has one tap outside [0, T)) and at C = 608, the widest C % 32 == 0
    the dispatch admits: within the tolerance of the plain version, the
    taps reversed must miss it, a rerun gives the same bits."""
    from mudg_tpu_torch.kernels import tconv as TC

    c = shape[-1]
    gen = torch.Generator(device=dev).manual_seed(30)
    norm, conv = _mods(dev, gen, nn.GroupNorm(32, c), nn.Conv3d(c, c, (3, 1, 1)))
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 1).bfloat16()
    packed = TC.pack_tconv(conv, norm)
    before = TC.launches
    got = TC.fused_gn_silu_tconv(x, norm, conv, packed)
    assert TC.launches == before + 1
    zero = torch.zeros_like(x)
    ref = _close(got, TC.plain_gn_silu_tconv(x, norm, conv), base=zero)
    _sees(TC.plain_gn_silu_tconv(x, norm, _taps_reversed(conv)), ref, zero)
    assert torch.equal(got, TC.fused_gn_silu_tconv(x, norm, conv, packed))


def test_gn_silu_tconv_kernel_at_a_dc_offset(dev):
    """Kernel 4 on a video at a DC offset of 1e3 whose groups vary little
    (1e3 + 4 s, P(s = +-1) = 1/128 each): within the tolerance of the plain
    version run in float64, where the one-pass variance misses it (or
    turns negative)."""
    from mudg_tpu_torch.kernels import norms as N
    from mudg_tpu_torch.kernels import tconv as TC
    from mudg_tpu_torch.nn import functional as F

    gen = torch.Generator(device=dev).manual_seed(31)
    norm, conv = _mods(dev, gen, nn.GroupNorm(32, 320), nn.Conv3d(320, 320, (3, 1, 1)))
    u = torch.rand(2, 16, 20, 32, 320, generator=gen, device=dev)
    x = (1e3 + 4.0 * ((u < 1 / 128).float() - (u > 1 - 1 / 128).float())).bfloat16()
    got = TC.fused_gn_silu_tconv(x, norm, conv, TC.pack_tconv(conv, norm))
    n64, c64 = copy.deepcopy(norm).double(), copy.deepcopy(conv).double()
    ref = TC.plain_gn_silu_tconv(x.double(), n64, c64).float()
    _close(got, ref)
    one_pass = F.temporal_conv311(conv, F.silu(N.plain_group_norm(
        x, norm.weight, norm.bias, 32, 1e-5, one_pass=True)))
    err = (one_pass.float() - ref).abs().nan_to_num(math.inf).max().item()
    assert err > TOL * ref.abs().max().item(), err


# kernels 5 and 6: L = 64 (one half-empty block), 192 and 576 (L % 128 = 64,
# the last block half empty, B*H odd), 640, 1024 and 2560 (MDM512 ds2, ds1)
FLASH_SHAPES = [(3, 64, 1), (2, 192, 3), (3, 576, 3), (2, 640, 2), (1, 1024, 2), (1, 2560, 5)]


@pytest.mark.parametrize("b,l,h", FLASH_SHAPES)
def test_flash_attention_kernel(dev, b, l, h):
    """Kernel 5 on strided q/k/v views of one packed (B, L, 3, H, 64)
    tensor, o and lse against the plain version; half the keys must miss."""
    from mudg_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(6)
    qkv = torch.randn(b, l, 3, h, 64, generator=gen, device=dev).bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    before = FA.launches
    o, lse = FA.flash_attention(q, k, v)
    assert FA.launches == before + 1
    o_ref, lse_ref = FA.plain_flash_attention(q, k, v)
    ref = _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-2
    _sees(FA.plain_flash_attention(q, k[:, :l // 2].repeat(1, 2, 1, 1),
                                   v[:, :l // 2].repeat(1, 2, 1, 1))[0], ref, torch.zeros_like(o))


def _perm8(x):
    """x (B, L, ...) with the sequence permuted inside each 8-group by [0, 2,
    4, 6, 1, 3, 5, 7]: the fp32 kernels' order of P's and dS's keys in
    their register fragments, applied to one operand of a product alone (a
    planted fault)."""
    idx = torch.arange(x.shape[1], device=x.device).view(-1, 8)[:, [0, 2, 4, 6, 1, 3, 5, 7]]
    return x[:, idx.reshape(-1)]


def _tf32(x):
    """x rounded to TF32 (to nearest, ties away from zero), as one TF32
    product would take it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("b,l,h", FLASH_SHAPES)
def test_flash_attention_f32_kernel(dev, b, l, h):
    """Kernel 5 in fp32 (3xTF32 wgmma products) on strided views of one
    (B, L, 3, H, 64) tensor: o within 1e-5 * max|ref| of the plain version,
    lse within 1e-5; V's keys permuted as P's fragments order them (the
    fragment fault) and one TF32 product must miss."""
    from mudg_tpu_torch.kernels import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = torch.randn(b, l, 3, h, 64, generator=gen, device=dev).unbind(2)
    assert not q.is_contiguous()
    before = FA.launches
    o, lse = FA.flash_attention(q, k, v)
    assert FA.launches == before + 1 and o.dtype == torch.float32
    o_ref, lse_ref = FA.plain_flash_attention(q, k, v)
    torch.cuda.synchronize()
    scale = o_ref.abs().max().item()
    assert (o - o_ref).abs().max().item() <= 1e-5 * scale
    assert (lse - lse_ref).abs().max().item() <= 1e-5
    fault = FA.plain_flash_attention(q, k, _perm8(v))[0]
    assert (fault - o_ref).abs().max().item() > 1e-5 * scale
    one_pass = FA.plain_flash_attention(*(_tf32(t) for t in (q, k, v)))[0]
    assert (one_pass - o_ref).abs().max().item() > 1e-5 * scale


@pytest.mark.parametrize("b,l,c", [(2, 576, 640), (3, 576, 320)])
def test_spatial_attn_kernel_tail(dev, b, l, c):
    """Kernel 1 at L = 576 (L % 128 == 64: the flash core's last 128-row
    block half empty, its keys past L masked) and C = 640 (10 heads, the
    q|k|v GEMM's N = 1920): within the tolerance of the plain version; the
    softmax scale applied twice (the core's qscale 0.125 * log2(e) on the
    folded Wq) and zeroed attention must miss it."""
    from mudg_tpu_torch.kernels import spatial_attn as SP
    from mudg_tpu_torch.nn.attention import CrossAttention

    heads = c // 64
    gen = torch.Generator(device=dev).manual_seed(8)
    norm, attn = _mods(dev, gen, nn.LayerNorm(c), CrossAttention(c, heads=heads))
    _sharpen(attn)
    x = torch.randn(b, l, c, generator=gen, device=dev).bfloat16()
    before = SP.launches
    got = SP.fused_self_attention(x, norm, attn, heads, SP.pack_stage(norm, attn, heads))
    assert SP.launches == before + 1
    ref = _close(got, SP.plain_self_attention(x, norm, attn, heads), base=x)
    twice = copy.deepcopy(attn)
    with torch.no_grad():
        twice.to_q.weight.mul_(64 ** -0.5)
    _sees(SP.plain_self_attention(x, norm, twice, heads), ref, x)
    _sees(SP.plain_self_attention(x, norm, _zero_v(attn), heads), ref, x)


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
    # fp32 is taken (the Pallas kernel takes any dtype): it matches plain
    o, lse = FA.flash_attention(q.float(), q.float(), q.float())
    o_ref, lse_ref = FA.plain_flash_attention(q.float(), q.float(), q.float())
    torch.cuda.synchronize()
    assert (o - o_ref).abs().max().item() <= 1e-5 * o_ref.abs().max().item()
    assert (lse - lse_ref).abs().max().item() <= 1e-5
    with pytest.raises(ValueError):   # fp16
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):   # L not a multiple of 64
        FA.flash_attention(q[:, :96], q[:, :96], q[:, :96])


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
    # no such site at this size; the backward kernels run only in training,
    # kernel 13 only in the 3DGS path
    assert counts.pop("flash_attention") == 0
    # kernels 11 and 12 only with MUDG_FUSED_NORMS=1 / MUDG_SHORT_ATTN=1, unset here
    for name in [n for n in counts if n.endswith("_bwd") or n.startswith("tile_")
                 or n in ("group_norm", "layer_norm", "short_kv_attention",
                          "packed_short_attention")]:
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


@pytest.mark.parametrize("b,l,h", FLASH_SHAPES)
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


@pytest.mark.parametrize("b,l,h", [(2, 192, 3), (3, 576, 3), (2, 640, 2), (1, 2560, 5)])
def test_flash_attention_bwd_f32_kernel(dev, b, l, h):
    """Kernel 6 in fp32 (3xTF32 wgmma products) on strided views of one
    (B, L, 3, H, 64) tensor against the plain backward, each gradient within
    1e-4 * max|ref| (fp32 sums in another order), with the planted faults
    (delta dropped; V's keys permuted as P's fragments order them; one TF32
    product); two runs bit for bit."""
    from mudg_tpu_torch.kernels import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(17)
    q, k, v = torch.randn(b, l, 3, h, 64, generator=gen, device=dev).unbind(2)
    do = torch.randn(b, l, h, 64, generator=gen, device=dev)
    o, lse = FA.plain_flash_attention(q, k, v)
    before = FA.bwd_launches
    got = FA.flash_attention_bwd(q, k, v, o, lse, do)
    assert FA.bwd_launches == before + 1
    ref = FA.plain_flash_attention_bwd(q, k, v, o, lse, do)
    _grads_close(got, ref, tol=1e-4)
    _bit_equal(got, FA.flash_attention_bwd(q, k, v, o, lse, do))
    _grads_miss(FA.plain_flash_attention_bwd(q, k, v, o, lse, do, delta=torch.zeros_like(lse)),
                ref, tol=1e-4)
    _grads_miss(FA.plain_flash_attention_bwd(q, k, _perm8(v), o, lse, do), ref, tol=1e-4)
    _grads_miss(FA.plain_flash_attention_bwd(*(_tf32(t) for t in (q, k, v)), o, lse, _tf32(do)),
                ref, tol=1e-4)


def test_flash_attention_launches_from_another_thread(dev):
    """Kernels 5 and 6 launch from a host thread other than the one that
    first launched them (autograd runs a backward on its own device
    thread): their raised shared-memory limit holds there too."""
    import threading

    from mudg_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(18)
    q, k, v, do = (torch.randn(2, 256, 2, 64, generator=gen, device=dev).bfloat16()
                   for _ in range(4))
    o, lse = FA.flash_attention(q, k, v)
    ref = FA.flash_attention_bwd(q, k, v, o, lse, do)
    out = []

    def run():
        try:
            out.append((FA.flash_attention(q, k, v), FA.flash_attention_bwd(q, k, v, o, lse, do)))
        except RuntimeError as e:   # a refused launch
            out.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and len(out) == 1
    assert not isinstance(out[0], RuntimeError), out[0]
    (o2, lse2), grads = out[0]
    _bit_equal((o2, lse2), (o, lse))
    _bit_equal(grads, ref)


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


@pytest.mark.parametrize("m,c", [(8192, 320), (2048, 1280)])
def test_geglu_ff_bwd_kernel_widths(dev, m, c):
    """Kernel 10 at C = 320 and 1280 (inner 1280 and 5120) against the plain
    GEGLU backward, the planted fault missing; a rerun gives the same bits
    (fixed-order split and column sums)."""
    from mudg_tpu_torch.kernels import mlp as M
    from mudg_tpu_torch.nn.attention import FeedForward

    gen = torch.Generator(device=dev).manual_seed(22)
    ff = _randomize(FeedForward(c).to(dev), gen)
    w1, b1, w2, _ = M.ff_params(ff)
    x = torch.randn(m, c, generator=gen, device=dev).bfloat16()
    dy = torch.randn(m, c, generator=gen, device=dev).bfloat16()
    with torch.no_grad():
        got = M.geglu_ff_bwd(x, dy, w1, b1, w2)
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


# ---------------------------------------------------------------------------
# Kernel 13: 3DGS tile compositing
# ---------------------------------------------------------------------------

def _gs_pairs(dev, n=400, npay=4, opacity=None, seed=15):
    """A seeded scene of tests/test_tile_raster.py's kind at 96x64 as the
    sorted pair table kernel 13 takes."""
    from mudg_tpu_torch.gs import gaussians as G
    from mudg_tpu_torch.gs import tile_raster as TT

    gen = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.randn(n, 3, generator=gen, device=dev) * 2.0 + torch.tensor([0, 0, 10.0],
                                                                             device=dev)
    g = G.init_from_points(xyz, torch.rand(n, 3, generator=gen, device=dev), opacity=0.35)
    if opacity is not None:
        g = g._replace(opacity=torch.full((n,), opacity, device=dev))
    k = torch.tensor([[60.0, 0, 48.0], [0, 60.0, 32.0], [0, 0, 1]], device=dev)
    proj = G.project_gaussians(g, k, torch.eye(4, device=dev), width=96, height=64)
    extras = (torch.softmax(torch.randn(n, npay - 4, generator=gen, device=dev), -1)
              if npay > 4 else None)
    feats, bounds, _ = TT.build_pairs(proj, g.colors, width=96, height=64, extras=extras)
    return feats.contiguous(), bounds, 6, gen


@pytest.mark.parametrize("opacity,npay", [(None, 4), (3.0, 4), (None, 23)])
def test_tile_composite_kernels(dev, opacity, npay):
    """Kernel 13 forward (color, depth, T, extras within 1e-4 * max|ref|) and
    backward (each pair-row column group within 2e-3 * max|ref| + 1e-8)
    against the plain versions; the backward reruns bit for bit; the
    planted faults (back to front; no occlusion term) miss."""
    from mudg_tpu_torch.kernels import tile_raster as KT

    feats, bounds, tw, gen = _gs_pairs(dev, npay=npay, opacity=opacity)
    before = (KT.launches, KT.bwd_launches)
    out, last = KT.tile_composite(feats, bounds, tw, npay)
    ref, _ = KT.plain_tile_composite(feats, bounds, tw, npay)
    torch.cuda.synchronize()
    scale = ref.abs().amax(dim=(0, 2))
    assert torch.isfinite(out).all()
    assert ((out - ref).abs().amax(dim=(0, 2)) <= 1e-4 * scale).all()
    rev, _ = KT.plain_tile_composite(feats, bounds, tw, npay, reverse=True)
    assert ((rev - ref).abs().amax(dim=(0, 2)) > 1e-4 * scale).any()
    gout = torch.randn(out.shape, generator=gen, device=dev)
    got = KT.tile_composite_bwd(feats, bounds, out, last, gout, tw, npay)
    assert (KT.launches, KT.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = KT.plain_tile_composite_bwd(feats, bounds, gout, tw, npay)
    groups = [slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 6 + npay)]

    def ratio(a):
        return max(((a[:, s] - want[:, s]).abs().max() /
                    (2e-3 * want[:, s].abs().max() + 1e-8)).item() for s in groups)

    assert ratio(got) <= 1.0
    assert torch.equal(got, KT.tile_composite_bwd(feats, bounds, out, last, gout, tw, npay))
    assert ratio(KT.plain_tile_composite_bwd(feats, bounds, gout, tw, npay,
                                             drop_occlusion=True)) > 1.0


def _tile_table(dev, counts, npay, seed, tw=3, faint=(), opaque=()):
    """A pair table with counts[t] pairs in tile t (tw tiles a row), rows in
    tile order: splats centred in or near their tile with conics from
    sigmas of 0.7-4 px and correlations in (-0.8, 0.8), opacities U(0.05,
    0.5) and payloads U(0, 1); a tile in `faint` gets sigmas of 0.5-2 px and
    opacities U(0.01, 0.1), so that it never saturates; one in `opaque`
    wide splats (sigmas 8-20 px) with opacities U(0.999, 1), so that it
    saturates within its first pairs (and some alphas reach the 0.999
    clamp)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    rows = []
    for t, n in enumerate(counts):
        x0, y0 = (t % tw) * 16, (t // tw) * 16
        lo_s, hi_s, lo_o, hi_o = ((0.5, 2.0, 0.01, 0.1) if t in faint else
                                  (8.0, 20.0, 0.999, 1.0) if t in opaque else
                                  (0.7, 4.0, 0.05, 0.5))
        sig = lo_s + (hi_s - lo_s) * u(n, 2)
        sx, sy = sig[:, 0], sig[:, 1]
        rho = 0.8 * (2 * u(n) - 1)
        det = (sx * sy) ** 2 * (1 - rho ** 2)
        rows.append(torch.stack([x0 - 4 + 24 * u(n), y0 - 4 + 24 * u(n), sy ** 2 / det,
                                 -rho * sx * sy / det, sx ** 2 / det,
                                 lo_o + (hi_o - lo_o) * u(n)], 1))
        rows[-1] = torch.cat([rows[-1], u(n, npay)], 1)
    feats = torch.cat(rows).contiguous()
    ends = torch.tensor(counts, dtype=torch.int64).cumsum(0)
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64), ends]).int().to(dev)
    return feats, bounds, gen


def _check_tile_composite(feats, bounds, tw, npay, gen):
    """Kernel 13 against its plain versions as test_tile_composite_kernels
    holds it (forward 1e-4 * max|ref| per channel, each gradient column
    group 2e-3 * max|ref| + 1e-8), both kernels rerun bit for bit. Returns
    the plain version's out and last."""
    from mudg_tpu_torch.kernels import tile_raster as KT

    out, last = KT.tile_composite(feats, bounds, tw, npay)
    ref, ref_last = KT.plain_tile_composite(feats, bounds, tw, npay)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    scale = ref.abs().amax(dim=(0, 2))
    assert ((out - ref).abs().amax(dim=(0, 2)) <= 1e-4 * scale).all()
    again, last2 = KT.tile_composite(feats, bounds, tw, npay)
    assert torch.equal(out, again) and torch.equal(last, last2)
    gout = torch.randn(out.shape, generator=gen, device=out.device)
    got = KT.tile_composite_bwd(feats, bounds, out, last, gout, tw, npay)
    want = KT.plain_tile_composite_bwd(feats, bounds, gout, tw, npay)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for s in (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 6 + npay)):
        err = (got[:, s] - want[:, s]).abs().max().item()
        assert err <= 2e-3 * want[:, s].abs().max().item() + 1e-8, (s, err)
    assert torch.equal(got, KT.tile_composite_bwd(feats, bounds, out, last, gout, tw, npay))
    return ref, ref_last


@pytest.mark.parametrize("npay", [1, 4, 5, 8, 16, 23, 26])
def test_tile_composite_kernels_schedule_and_ring(dev, npay):
    """Kernel 13 at each payload width around its template edges on six
    tiles whose pair counts (0, 700, 3, 1500, 37, 1029) are in no order of
    tile index: an empty tile; a faint 700-pair tile (several forward and
    backward stages, no multiple of either, never saturating); an opaque
    1500-pair tile that saturates in its first stage, so that the stages in
    flight are drained; a 1029-pair tile that saturates on the way."""
    from mudg_tpu_torch.kernels import tile_raster as KT

    counts = [0, 700, 3, 1500, 37, 1029]
    feats, bounds, gen = _tile_table(dev, counts, npay, seed=40 + npay, faint={1}, opaque={3})
    assert KT.tile_order(bounds[1:] - bounds[:-1]).tolist() == [3, 5, 1, 4, 2, 0]
    ref, last = _check_tile_composite(feats, bounds, 3, npay, gen)
    t_final, tmax = ref[:, npay], last.amax(1)
    assert (t_final[0] == 1.0).all() and t_final[1].min() > 1e-2
    assert t_final[3].max() <= 1e-4 and tmax[3] < 64     # saturated in the first stage
    assert t_final[5].max() <= 1e-4 and tmax[5] > 256    # saturated past the first stage


@pytest.mark.parametrize("n_tiles,high", [(1, 5), (6, 2), (2400, 7000), (20000, 300)])
def test_tile_order_kernel(dev, n_tiles, high):
    """The kernels' tile sort (each tile's rank among all keys) against its
    plain version, with ties and empty tiles."""
    from mudg_tpu_torch.kernels import tile_raster as KT

    gen = torch.Generator().manual_seed(70 + n_tiles)
    work = (torch.rand(n_tiles, generator=gen) ** 4 * high).int()
    got = KT.tile_order(work.to(dev))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), KT.tile_order(work))


@pytest.mark.parametrize("npay", [4, 23])
def test_tile_composite_kernels_many_tiles(dev, npay):
    """Kernel 13 on 60 x 40 tiles, more than the persistent grid holds at
    once, so that each block streams several tiles through its ring: pair
    counts drawn heavy-tailed (most tiles light, some past 1000, a tenth
    empty), every seventh tile opaque (saturating at once, its stages in
    flight drained while the next tile's follow), every fifth faint."""
    gen = torch.Generator().manual_seed(50 + npay)
    n_tiles = 60 * 40
    counts = (torch.rand(n_tiles, generator=gen) ** 6 * 1400).long()
    counts[torch.rand(n_tiles, generator=gen) < 0.1] = 0
    counts = counts.tolist()
    feats, bounds, gen = _tile_table(
        dev, counts, npay, seed=60 + npay, tw=60,
        faint={t for t in range(n_tiles) if t % 5 == 0},
        opaque={t for t in range(n_tiles) if t % 7 == 0})
    _check_tile_composite(feats, bounds, 60, npay, gen)


def test_rasterize_tiles_gradients_match_the_plain_path(dev):
    """The tile rasterizer's gradients to every gaussian field on the card
    (kernel 13) against the same scene on the CPU (its plain versions)."""
    from mudg_tpu_torch.gs import gaussians as G
    from mudg_tpu_torch.gs import tile_raster as TT

    gen = torch.Generator(device=dev).manual_seed(16)
    xyz = torch.randn(300, 3, generator=gen, device=dev) * 2.0 + torch.tensor([0, 0, 10.0],
                                                                               device=dev)
    g = G.init_from_points(xyz, torch.rand(300, 3, generator=gen, device=dev), opacity=0.35)
    g = g._replace(log_scales=g.log_scales + 0.3 * torch.randn(300, 3, generator=gen,
                                                               device=dev),
                   quats=torch.randn(300, 4, generator=gen, device=dev))
    k = torch.tensor([[60.0, 0, 48.0], [0, 60.0, 32.0], [0, 0, 1]])
    names = ("means", "log_scales", "quats", "opacity", "colors")
    grads = {}
    for d in (dev, torch.device("cpu")):
        leaves = [getattr(g, n).to(d).clone().requires_grad_() for n in names]
        gd = G.Gaussians(*[None if x is None else x.to(d) for x in g])._replace(
            **dict(zip(names, leaves)))
        out = TT.rasterize_tiles(gd, k.to(d), torch.eye(4, device=d), width=96, height=64)
        loss = ((out.color - 0.25) ** 2).mean() + 0.1 * out.alpha.mean() + 1e-3 * out.depth.mean()
        grads[d.type] = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(names, grads["cuda"], grads["cpu"]):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 2e-3 * b.abs().max().item() + 1e-8, (name, err)


def test_tile_composite_rejects_what_the_kernel_does_not_take(dev):
    from mudg_tpu_torch.kernels import tile_raster as KT

    feats, bounds, tw, _ = _gs_pairs(dev)
    with pytest.raises(ValueError):   # fp64 pair table
        KT.tile_composite(feats.double(), bounds, tw, 4)
    with pytest.raises(ValueError):   # int64 bounds
        KT.tile_composite(feats, bounds.long(), tw, 4)
    with pytest.raises(ValueError):   # npay not matching the table's width
        KT.tile_composite(feats, bounds, tw, 5)
    with pytest.raises(ValueError):   # a non-contiguous table
        KT.tile_composite(torch.cat([feats, feats], 1)[:, ::2], bounds, tw, 4)
    wide = torch.zeros(feats.shape[0], 6 + 27, device=dev)
    with pytest.raises(ValueError):   # more payload channels than the kernel takes
        KT.tile_composite(wide, bounds, tw, 27)



# ---------------------------------------------------------------------------
# Kernels 11 and 12
# ---------------------------------------------------------------------------

def _norm_input(dev, gen, shape, dtype, offset=0.0):
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) * (0.5 + torch.rand(c, generator=gen,
                                                                           device=dev))
         + 3 * torch.randn(c, generator=gen, device=dev) + 3 + offset)
    w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    return x.to(dtype), w, b


@pytest.mark.parametrize("shape,dtype", [((32, 20, 32, 640), torch.bfloat16),
                                         ((2, 16, 5, 8, 1280), torch.bfloat16),
                                         ((3, 7, 9, 64), torch.bfloat16),
                                         ((4, 10, 16, 2560), torch.bfloat16),
                                         ((16, 20, 32, 320), torch.float32)])
def test_group_norm_kernel(dev, shape, dtype):
    """GN against its plain version (fp32 within 1e-5 * max|ref|), reruns
    bit for bit, and the group map shifted by one channel is seen."""
    from mudg_tpu_torch.kernels import norms as N

    gen = torch.Generator(device=dev).manual_seed(20)
    x, w, b = _norm_input(dev, gen, shape, dtype)
    before = N.launches
    got = N.fused_group_norm(x, w, b, 32, 1e-5)
    assert N.launches == before + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    ref = N.plain_group_norm(x, w, b, 32, 1e-5).float()
    tol = TOL if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert torch.equal(got, N.fused_group_norm(x, w, b, 32, 1e-5))
    fault = N.plain_group_norm(x, w, b, 32, 1e-5, shift_groups=1).float()
    assert (fault - ref).abs().max().item() > tol * ref.abs().max().item()


def test_group_norm_kernel_at_a_dc_offset(dev):
    """fp32 at a DC offset of 1e3: within 1e-5 * max|ref| of the plain
    version in float64, where the one-pass variance is not."""
    from mudg_tpu_torch.kernels import norms as N

    gen = torch.Generator(device=dev).manual_seed(21)
    x, w, b = _norm_input(dev, gen, (8, 20, 32, 640), torch.float32, offset=1e3)
    got = N.fused_group_norm(x, w, b, 32, 1e-5)
    ref = N.plain_group_norm(x.double(), w.double(), b.double(), 32, 1e-5).float()
    bound = 1e-5 * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= bound
    one_pass = N.plain_group_norm(x, w, b, 32, 1e-5, one_pass=True)
    assert (one_pass - ref).abs().max().item() > bound


@pytest.mark.parametrize("shape,dtype", [((32, 640, 640), torch.bfloat16),
                                         ((320, 16, 1280), torch.bfloat16),
                                         ((5, 7, 2560), torch.bfloat16),
                                         ((16, 64, 1024), torch.float32)])
def test_layer_norm_kernel(dev, shape, dtype):
    from mudg_tpu_torch.kernels import norms as N

    gen = torch.Generator(device=dev).manual_seed(22)
    x, w, b = _norm_input(dev, gen, shape, dtype)
    before = N.ln_launches
    got = N.fused_layer_norm(x, w, b, 1e-5)
    assert N.ln_launches == before + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    ref = N.plain_layer_norm(x, w, b, 1e-5).float()
    tol = TOL if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - ref).abs().max().item() <= tol * ref.abs().max().item()
    fault = N.plain_layer_norm(x, w, b, 1e-5, center=False).float()
    assert (fault - ref).abs().max().item() > tol * ref.abs().max().item()


BF, F32 = torch.bfloat16, torch.float32


def _norm_close(got, ref, dtype):
    tol = TOL if dtype == BF else 1e-5
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()


# kernel 11's GroupNorm at N = 1, 2 and 32 samples and C from 320 to 2560, on
# the one-launch cluster path and on the two passes (the largest fp32 sample
# group_norm_fits admits, 1,048,576 elements, and kernel 4's MDM512 clip),
# weights as stored (bf16 with bf16 x), each rerun bit for bit
@pytest.mark.parametrize("shape,dtype,cluster", [
    ((1, 16, 5, 8, 1280), BF, True), ((1, 20, 32, 2560), BF, True),
    ((2, 16, 10, 16, 640), BF, True), ((32, 40, 64, 320), BF, True),
    ((32, 10, 16, 2560), BF, True), ((2, 48, 32, 1024), BF, True),
    ((32, 20, 32, 1280), F32, True), ((2, 32, 32, 1024), F32, False),
    ((2, 16, 40, 64, 320), BF, False)])
def test_group_norm_plans(dev, shape, dtype, cluster):
    from mudg_tpu_torch.kernels import norms as N

    gen = torch.Generator(device=dev).manual_seed(27)
    x, w, b = _norm_input(dev, gen, shape, dtype)
    w, b = w.to(dtype), b.to(dtype)
    n, c = shape[0], shape[-1]
    plan = N.gn_plan_card(n, math.prod(shape[1:-1]), c, x.element_size())
    assert (plan.cluster > 0) == cluster, plan
    got = N.fused_group_norm(x, w, b, 32, 1e-5)
    _norm_close(got, N.plain_group_norm(x, w, b, 32, 1e-5), dtype)
    for _ in range(3):
        assert torch.equal(got, N.fused_group_norm(x, w, b, 32, 1e-5))


def test_group_norm_two_passes_at_a_dc_offset(dev):
    """The two-pass path (the largest fp32 sample) at a DC offset of 1e3:
    within 1e-5 * max|ref| of the plain version in float64."""
    from mudg_tpu_torch.kernels import norms as N

    gen = torch.Generator(device=dev).manual_seed(28)
    x, w, b = _norm_input(dev, gen, (2, 32, 32, 1024), F32, offset=1e3)
    assert N.gn_plan_card(2, 1024, 1024, 4).cluster == 0
    got = N.fused_group_norm(x, w, b, 32, 1e-5)
    ref = N.plain_group_norm(x.double(), w.double(), b.double(), 32, 1e-5).float()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_group_norm_cluster_path_is_one_launch(dev):
    """At every GN shape of chip_smoke.py's tables the card plans one cluster
    per sample, and a call is one kernel launch: no scratch to clear, no
    cast of bf16 or fp32 weights."""
    import chip_smoke as CS
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mudg_tpu_torch.kernels import norms as N

    for cfg, shapes in CS.GN_SHAPES.items():
        for shape in shapes:
            itemsize = 4 if cfg.endswith("-f32") else 2
            plan = N.gn_plan_card(shape[0], math.prod(shape[1:-1]), shape[-1], itemsize)
            assert plan.cluster > 0, (cfg, shape, plan)
    gen = torch.Generator(device=dev).manual_seed(29)
    for dtype in (BF, F32):
        x, w, b = _norm_input(dev, gen, (32, 20, 32, 640), dtype)
        w, b = w.to(dtype), b.to(dtype)
        N.fused_group_norm(x, w, b, 32, 1e-5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            N.fused_group_norm(x, w, b, 32, 1e-5)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        assert len(kernels) == 1 and kernels[0].count == 1, [(e.key, e.count) for e in kernels]
        assert "gn_cluster_kernel" in kernels[0].key


# kernel 11's LayerNorm at N = 1, 2 and 32 and C from 320 to 4096 (C = 328:
# the last vectors of a row masked), on both sides of the switch between
# the row and the tile kernel (bf16 from C = 1280 and 24 MiB of x: tile),
# weights as stored, rerun bit for bit
@pytest.mark.parametrize("shape,dtype,tile", [
    ((1, 256, 1024), BF, False), ((2, 9216, 320), BF, False), ((32, 2560, 320), BF, False),
    ((32, 40, 1280), BF, False), ((288, 16, 1280), BF, False), ((1152, 16, 1280), BF, True),
    ((32, 576, 1280), BF, True), ((2, 4608, 2560), BF, True), ((2, 77, 512), BF, False),
    ((1152, 16, 1280), F32, False), ((32, 144, 1280), F32, False), ((2, 640, 640), F32, False),
    ((3, 5, 4096), F32, False), ((13, 3, 328), BF, False)])
def test_layer_norm_plans(dev, shape, dtype, tile):
    from mudg_tpu_torch.kernels import norms as N

    gen = torch.Generator(device=dev).manual_seed(30)
    x, w, b = _norm_input(dev, gen, shape, dtype)
    w, b = w.to(dtype), b.to(dtype)
    c = shape[-1]
    assert N.ln_plan_card(x.numel() // c, c, x.element_size())[0] == int(tile)
    got = N.fused_layer_norm(x, w, b, 1e-5)
    _norm_close(got, N.plain_layer_norm(x, w, b, 1e-5), dtype)
    for _ in range(3):
        assert torch.equal(got, N.fused_layer_norm(x, w, b, 1e-5))


def _ln_tile_rows(nr, threads, team):
    """ln_tile_kernel's rows of one tile of nr rows: team tm takes rows tm,
    tm + teams, .. over ceil(nr / teams) uniform steps, storing the valid ones."""
    teams = threads // team
    q = (np.arange(teams)[:, None] + teams * np.arange(-(-nr // teams))[None, :]).ravel()
    return q[q < nr]


def test_ln_plan_covers_each_row_once(dev):
    """The C launcher's LayerNorm plan (`mudg_ln_plan`, the one kernels 1, 2,
    3 and 9 and the wrapper take) at every LN shape of chip_smoke.py's
    tables and a few more: the tile kernel exactly in bf16 from C = 1280 and
    24 MiB of x, every row covered once by its grid (the kernels' walks
    mirrored), at most 227 KB of shared memory a block, and the tile
    kernel's lanes all busy at C = 1280."""
    import chip_smoke as CS

    from mudg_tpu_torch.kernels import norms as N

    cases = [(math.prod(s[:-1]), s[-1], 4 if cfg.endswith("-f32") else 2)
             for cfg, shapes in CS.LN_SHAPES.items() for s in shapes]
    cases += [(35, 2560, 2), (3, 4096, 4), (13, 328, 2), (9, 1600, 2), (18432, 2560, 2),
              (36864, 1024, 2), (9216, 4096, 2)]
    for rows, c, itemsize in cases:
        tile, team, vpt, threads, tile_rows, smem, grid = N.ln_plan_card(rows, c, itemsize)
        assert tile == int(itemsize == 2 and c >= 1280 and rows * c * 2 >= 24 << 20)
        seen = np.zeros(rows, dtype=np.int64)
        if not tile:   # a warp a row, 8 rows a block, vpt vectors of 8 a lane
            want = 1
            while want * 32 < c // 8:
                want *= 2
            assert (team, vpt, threads, grid) == (32, want, 256, -(-rows // 8))
            seen[:] = 1
        else:
            chunks = c * itemsize // 16
            assert team in (1, 2, 4, 8, 16, 32) and threads % 32 == 0 and threads <= 256
            assert smem <= N.SMEM_MAX and (vpt == 0 or team * vpt >= chunks)
            if c == 1280:   # the model's width the tile kernel takes: in registers
                assert team * vpt == chunks
            tiles = -(-rows // tile_rows)
            assert 1 <= grid <= tiles
            for block in range(grid):   # the persistent walk over tiles
                for t in range(block, tiles, grid):
                    nr = min(tile_rows, rows - t * tile_rows)
                    seen[t * tile_rows + _ln_tile_rows(nr, threads, team)] += 1
        assert (seen == 1).all(), (rows, c, itemsize)


@pytest.mark.parametrize("b,lq,lk,h,d,dtype", [(4, 2560, 77, 5, 64, torch.bfloat16),
                                               (4, 2304, 16, 10, 64, torch.bfloat16),
                                               (2, 256, 16, 2, 64, torch.bfloat16),
                                               (2, 256, 77, 2, 64, torch.bfloat16),
                                               (2, 256, 16, 2, 128, torch.bfloat16),
                                               (2, 256, 77, 2, 128, torch.bfloat16),
                                               (3, 512, 128, 2, 64, torch.bfloat16),
                                               (3, 512, 129, 2, 64, torch.bfloat16),
                                               (2, 256, 1024, 2, 128, torch.bfloat16),
                                               (2, 512, 93, 3, 128, torch.bfloat16),
                                               (2, 256, 1, 2, 64, torch.bfloat16),
                                               (4, 2560, 77, 5, 64, torch.float32),
                                               (2, 256, 1024, 2, 128, torch.float32),
                                               (2, 512, 93, 3, 128, torch.float32),
                                               (2, 256, 1, 2, 64, torch.float32),
                                               (2, 256, 16, 2, 64, torch.float32),
                                               (3, 512, 128, 2, 64, torch.float32),
                                               (3, 512, 129, 2, 64, torch.float32),
                                               (2, 256, 48, 3, 64, torch.float32),
                                               (2, 256, 112, 2, 64, torch.float32)])
def test_short_kv_attention_kernel(dev, b, lq, lk, h, d, dtype):
    """Against the dense plain version across the predicate (Lk up to 1024,
    D 64 and 128, Lq down to 256; fp32 within 1e-5 * max|ref|) on every
    route, and both sides of their boundary (Lk 128 and 129 at D 64, in
    both dtypes); k and v strided; unmasked padded keys are seen; a rerun
    gives the same bits."""
    from mudg_tpu_torch.kernels import short_attention as SA

    gen = torch.Generator(device=dev).manual_seed(23)
    q = torch.randn(b, lq, h, d, generator=gen, device=dev).to(dtype)
    k, v = torch.randn(b, lk, 2, h, d, generator=gen, device=dev).to(dtype).unbind(2)
    before = SA.launches
    got = SA.short_kv_attention(q, k, v)
    assert SA.launches == before + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    ref = SA.plain_short_attention(q, k, v).float()
    tol = TOL if dtype == torch.bfloat16 else 1e-5
    assert torch.isfinite(got).all()
    assert (got.float() - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert SA.short_kv_route(dtype, d, lk) == ("tma" if dtype == torch.bfloat16 else "tf32")
    assert SA.short_kv_plan(dtype, b, lq, lk, h, d).chunked == (lk > 128 or (
        dtype == torch.float32 and d == 128))
    assert torch.equal(got, SA.short_kv_attention(q, k, v))
    if lk % 64:
        pad = (0, 0, 0, 0, 0, -lk % 64)
        fault = SA.plain_short_attention(q, torch.nn.functional.pad(k, pad),
                                         torch.nn.functional.pad(v, pad))
        assert (fault.float() - ref).abs().max().item() > tol * ref.abs().max().item()


@pytest.mark.parametrize("b,t,h,d", [(1280, 16, 10, 64), (64, 8, 2, 64), (32, 4, 4, 128),
                                     (16, 32, 2, 64), (8, 64, 2, 128), (128, 1, 1, 64)])
def test_packed_short_attention_kernel(dev, b, t, h, d):
    from mudg_tpu_torch.kernels import short_attention as SA

    gen = torch.Generator(device=dev).manual_seed(24)
    q, k, v = torch.randn(b, t, 3, h, d, generator=gen, device=dev).bfloat16().unbind(2)
    before = SA.packed_launches
    got = SA.packed_short_attention(q, k, v)
    assert SA.packed_launches == before + 1
    ref = _close(got, SA.plain_short_attention(q, k, v))
    if b > 1 and t > 1:
        fault = SA.plain_short_attention(q, k.roll(1, 0), v.roll(1, 0))
        assert (fault.float() - ref).abs().max().item() > TOL * ref.abs().max().item()


def test_norm_and_short_ops_grads_match_plain_autograd(dev):
    """Each kernel-11/12 autograd op's gradients against autograd of its
    plain math (within 5e-2 * max|ref|)."""
    from mudg_tpu_torch.kernels import norms as N
    from mudg_tpu_torch.kernels import short_attention as SA

    gen = torch.Generator(device=dev).manual_seed(25)

    def grads(fn, ins, dy):
        ins = [t.detach().requires_grad_() for t in ins]
        return torch.autograd.grad(fn(*ins), ins, dy)

    x, w, b = _norm_input(dev, gen, (8, 10, 16, 640), torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=dev).bfloat16()
    _grads_close(grads(lambda *a: N.group_norm_op(*a, 32, 1e-5), (x, w, b), dy),
                 grads(lambda *a: N.plain_group_norm(*a, 32, 1e-5), (x, w, b), dy))
    x, w, b = _norm_input(dev, gen, (8, 160, 1280), torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=dev).bfloat16()
    _grads_close(grads(lambda *a: N.layer_norm_op(*a, 1e-5), (x, w, b), dy),
                 grads(lambda *a: N.plain_layer_norm(*a, 1e-5), (x, w, b), dy))
    q = torch.randn(2, 512, 5, 64, generator=gen, device=dev).bfloat16()
    k, v = torch.randn(2, 77, 2, 5, 64, generator=gen, device=dev).bfloat16().unbind(2)
    dy = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    _grads_close(grads(SA.short_kv_attention_op, (q, k, v), dy),
                 grads(SA.plain_short_attention, (q, k, v), dy))
    q, k, v = torch.randn(64, 16, 3, 4, 64, generator=gen, device=dev).bfloat16().unbind(2)
    dy = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    _grads_close(grads(SA.packed_short_attention_op, (q, k, v), dy),
                 grads(SA.plain_short_attention, (q, k, v), dy))


def test_norm_and_short_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from mudg_tpu_torch.kernels import norms as N
    from mudg_tpu_torch.kernels import short_attention as SA

    w, b = torch.ones(60, device=dev), torch.zeros(60, device=dev)
    with pytest.raises(ValueError):   # C not a multiple of 8
        N.fused_group_norm(torch.randn(2, 4, 4, 60, device=dev), w, b, 6, 1e-5)
    with pytest.raises(ValueError):   # fp16
        N.fused_layer_norm(torch.randn(2, 4, 64, device=dev).half(), w[:4].repeat(16),
                           b[:4].repeat(16), 1e-5)
    with pytest.raises(ValueError):   # groups not dividing C
        N.fused_group_norm(torch.randn(2, 4, 4, 64, device=dev), w[:4].repeat(16),
                           b[:4].repeat(16), 24, 1e-5)
    q = torch.randn(2, 256, 2, 64, device=dev)
    with pytest.raises(ValueError):   # fp16: bf16 or fp32 only, no plain fallback
        SA.short_kv_attention(q.half(), q[:, :77].half(), q[:, :77].half())
    with pytest.raises(ValueError):   # k's dtype not q's
        SA.short_kv_attention(q, q[:, :77].bfloat16(), q[:, :77])
    with pytest.raises(ValueError):   # packed: bf16 only
        SA.packed_short_attention(*(torch.randn(16, 16, 2, 64, device=dev),) * 3)
    with pytest.raises(ValueError):   # Lq not a multiple of 256
        SA.short_kv_attention(q[:, :192].bfloat16(), q[:, :77].bfloat16(),
                              q[:, :77].bfloat16())
    with pytest.raises(ValueError):   # Lk > 1024
        k = torch.randn(2, 1100, 2, 64, device=dev).bfloat16()
        SA.short_kv_attention(q.bfloat16(), k, k)
    with pytest.raises(ValueError):   # head dim 32
        SA.packed_short_attention(*(torch.randn(16, 16, 2, 32, device=dev).bfloat16(),) * 3)
    with pytest.raises(ValueError):   # T = 3
        SA.packed_short_attention(*(torch.randn(128, 3, 2, 64, device=dev).bfloat16(),) * 3)


def test_small_unet_switch_path_matches_fp32(dev, monkeypatch):
    """The small UNet of test_small_unet_kernel_path_matches_fp32 with
    MUDG_FUSED_NORMS=1 and MUDG_SHORT_ATTN=1 (16x16 latents: the spatial
    cross-attention's 256 queries take the short-KV kernel): kernels 11 and
    12 launch, and the gate against the fp32 plain path holds."""
    import mudg_tpu_torch.kernels as K
    from mudg_tpu_torch.nn import unet3d as U

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = U.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                       attention_resolutions=(1,), context_dim=32)
    gen = torch.Generator(device=dev).manual_seed(26)
    unet = _randomize(U.UNet3D(cfg).to(dev), gen).eval()
    x = torch.randn(1, 16, 16, 16, 12, generator=gen, device=dev)
    ctx = torch.randn(1, 77 + 256, 32, generator=gen, device=dev)
    ts = torch.tensor([500], device=dev)
    with torch.no_grad():
        ref = unet(x, ts, ctx, c_label=ts * 0)
        unet.bfloat16()
        K.prepare_kernels(unet)
        plain = unet(x.bfloat16(), ts, ctx.bfloat16(), c_label=ts * 0, impl="plain")
        monkeypatch.setenv("MUDG_FUSED_NORMS", "1")
        monkeypatch.setenv("MUDG_SHORT_ATTN", "1")
        K.reset_launch_counts()
        got = unet(x.bfloat16(), ts, ctx.bfloat16(), c_label=ts * 0)
    counts = K.launch_counts()
    assert all(counts[k] > 0 for k in ("group_norm", "layer_norm", "short_kv_attention")), counts
    e_k = ((got.float() - ref).norm() / ref.norm()).item()
    e_p = ((plain.float() - ref).norm() / ref.norm()).item()
    assert e_k <= 1.5 * e_p + 5e-3, (e_k, e_p)


def test_small_unet_kernel_spans_hold_every_port_kernel(dev, monkeypatch):
    """The small UNet of test_small_unet_switch_path_matches_fp32 with the
    program's spans on under the profiler: each kernel wrapper's span counts
    its launches, and every `mudg::` device op was launched (by the runtime
    or driver call that shares its correlation id) inside a `kernel.*`
    range, which per-kernel device time rests on."""
    import mudg_tpu_torch.kernels as K
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mudg_tpu_torch.nn import unet3d as U
    from mudg_tpu_torch.utils import profiling as P

    cfg = U.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                       attention_resolutions=(1,), context_dim=32)
    gen = torch.Generator(device=dev).manual_seed(26)
    unet = _randomize(U.UNet3D(cfg).to(dev), gen).eval().bfloat16()
    K.prepare_kernels(unet)
    x = torch.randn(1, 16, 16, 16, 12, generator=gen, device=dev).bfloat16()
    ctx = torch.randn(1, 77 + 256, 32, generator=gen, device=dev).bfloat16()
    ts = torch.tensor([500], device=dev)
    monkeypatch.setenv("MUDG_FUSED_NORMS", "1")
    monkeypatch.setenv("MUDG_SHORT_ATTN", "1")
    with torch.no_grad():
        unet(x, ts, ctx, c_label=ts * 0)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        P.reset_spans()
        P.enable_spans(True)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                unet(x, ts, ctx, c_label=ts * 0)
                torch.cuda.synchronize()
        finally:
            P.enable_spans(False)
    launched = {k: n for k, n in K.launch_counts().items() if n}
    assert {"spatial_attn", "temporal_attn", "geglu_ff", "gn_silu_tconv"} <= set(launched)
    spanned = {}
    for path, t in P.span_totals().items():
        name = path.rsplit("/", 1)[-1]
        if name.startswith("kernel."):
            spanned[name[len("kernel."):]] = spanned.get(name[len("kernel."):], 0) + t["count"]
    P.reset_spans()
    assert spanned == launched
    ranges, calls, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.is_user_annotation():
            if e.name().startswith("mudg.kernel."):
                ranges.append((e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CPU:
            if e.name().startswith("cu") and "::" not in e.name():   # runtime or driver call
                calls[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and "mudg::" in e.name():
            ops.append((e.name(), e.correlation_id()))
    assert ops
    unlinked = [n for n, corr in ops
                if corr not in calls or not any(s <= calls[corr] <= e for s, e in ranges)]
    assert not unlinked, unlinked[:5]


def test_small_unet_fp32_switch_path_matches_plain(dev, monkeypatch):
    """The small UNet in fp32 with impl="auto" and both switches: kernels 11
    and 12 take fp32 (the Pallas kernels take any dtype, and the JAX
    `sample` runs fp32 by default), no other kernel launches, and the output
    is within 1e-4 relative L2 of the fp32 plain path."""
    import mudg_tpu_torch.kernels as K
    from mudg_tpu_torch.nn import unet3d as U

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = U.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                       attention_resolutions=(1,), context_dim=32)
    gen = torch.Generator(device=dev).manual_seed(27)
    unet = _randomize(U.UNet3D(cfg).to(dev), gen).eval()
    x = torch.randn(1, 16, 16, 16, 12, generator=gen, device=dev)
    ctx = torch.randn(1, 77 + 256, 32, generator=gen, device=dev)
    ts = torch.tensor([500], device=dev)
    with torch.no_grad():
        ref = unet(x, ts, ctx, c_label=ts * 0, impl="plain")
        monkeypatch.setenv("MUDG_FUSED_NORMS", "1")
        monkeypatch.setenv("MUDG_SHORT_ATTN", "1")
        K.reset_launch_counts()
        got = unet(x, ts, ctx, c_label=ts * 0)
    counts = K.launch_counts()
    switch = ("group_norm", "layer_norm", "short_kv_attention")
    assert all(counts[k] > 0 for k in switch), counts
    assert all(v == 0 for k, v in counts.items() if k not in switch), counts
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-4


OPT_OUT = ("MUDG_FUSED_SPATIAL", "MUDG_STREAM_SPATIAL", "MUDG_FLASHBLOCK", "MUDG_FUSED_FF",
           "MUDG_FUSED_TEMPORAL", "MUDG_FUSED_TCONV")


def _wrapper_calls(cfg, args, monkeypatch):
    """Calls of kernels 1-5's wrappers in one bf16 forward of a UNet of
    `cfg` on the meta device, under the current environment."""
    from mudg_tpu_torch.nn import unet3d as U
    from mudg_tpu_torch.kernels import flash_attention as FA
    from mudg_tpu_torch.kernels import mlp as M
    from mudg_tpu_torch.kernels import spatial_attn as SP
    from mudg_tpu_torch.kernels import tconv as TC
    from mudg_tpu_torch.kernels import temporal_attn as TA

    calls = dict.fromkeys(("spatial_attn", "temporal_attn", "geglu_ff", "gn_silu_tconv",
                           "flash_attention"), 0)
    with monkeypatch.context() as mp:
        for mod, fn, name in ((SP, "fused_self_attention", "spatial_attn"),
                              (TA, "fused_double_self_attn", "temporal_attn"),
                              (M, "fused_geglu_ff", "geglu_ff"),
                              (M, "fused_geglu_ff_block", "geglu_ff"),
                              (TC, "fused_gn_silu_tconv", "gn_silu_tconv"),
                              (FA, "flash_attention", "flash_attention")):
            def counted(*a, _orig=getattr(mod, fn), _name=name, **k):
                calls[_name] += 1
                return _orig(*a, **k)
            mp.setattr(mod, fn, counted)
        with torch.device("meta"), torch.no_grad():
            meta = U.UNet3D(cfg).to(torch.bfloat16)
            meta(*(a.to("meta") for a in args[:3]), c_label=args[3].to("meta"))
    return calls


@pytest.mark.parametrize("switch", [*OPT_OUT, "all"])
def test_small_unet_opt_out_switches(dev, monkeypatch, switch):
    """The small UNet at 32x32 latents (ds1 L = 1024, so a spatial site off
    kernel 1 reaches kernel 5) with one of the JAX package's opt-out
    switches at "0" (or all six): each kernel launches exactly where the
    dispatch calls its wrapper (the same forward on the meta device; the CPU
    tests hold that dispatch against a trace of the JAX UNet), the switched
    kernels not at all, and the gate against the fp32 plain path holds."""
    import mudg_tpu_torch.kernels as K
    from mudg_tpu_torch.nn import unet3d as U

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = U.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                       attention_resolutions=(1,), context_dim=32)
    gen = torch.Generator(device=dev).manual_seed(28)
    unet = _randomize(U.UNet3D(cfg).to(dev), gen).eval()
    x = torch.randn(1, 16, 32, 32, 12, generator=gen, device=dev)
    ctx = torch.randn(1, 77 + 256, 32, generator=gen, device=dev)
    ts = torch.tensor([500], device=dev)
    for var in OPT_OUT:
        monkeypatch.delenv(var, raising=False)
    with torch.no_grad():
        ref = unet(x, ts, ctx, c_label=ts * 0)
        unet.bfloat16()
        K.prepare_kernels(unet)
        args = (x.bfloat16(), ts, ctx.bfloat16(), ts * 0)
        plain = unet(*args[:3], c_label=args[3], impl="plain")
        for var in OPT_OUT if switch == "all" else (switch,):
            monkeypatch.setenv(var, "0")
        expect = _wrapper_calls(cfg, args, monkeypatch)
        K.reset_launch_counts()
        got = unet(*args[:3], c_label=args[3])
    counts = K.launch_counts()
    assert {k: counts[k] for k in expect} == expect
    off = {"MUDG_FUSED_SPATIAL": ["spatial_attn"], "MUDG_FUSED_FF": ["geglu_ff"],
           "MUDG_FUSED_TEMPORAL": ["temporal_attn"], "MUDG_FUSED_TCONV": ["gn_silu_tconv"],
           "all": ["spatial_attn", "geglu_ff", "temporal_attn", "gn_silu_tconv"]}
    assert all(expect[k] == 0 for k in off.get(switch, [])), expect
    if switch in ("MUDG_FUSED_SPATIAL", "all"):
        assert expect["flash_attention"] > 0
    e_k = ((got.float() - ref).norm() / ref.norm()).item()
    e_p = ((plain.float() - ref).norm() / ref.norm()).item()
    assert e_k <= 1.5 * e_p + 5e-3, (e_k, e_p)
