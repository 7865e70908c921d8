"""Kernel 4: the fused GroupNorm + SiLU + temporal conv (3,1,1) stage
(CUDA, `csrc/tconv.cu`).

One TemporalConvBlock stage over a video x (B, T, H, W, C). Replaces
`mudg_tpu/kernels/tconv.py:_kernel` (fused_gn_silu_tconv); the design note is
at the top of the .cu file: the GroupNorm statistics and h = silu(GN(x)) by
kernel 11's GroupNorm passes, then the three-tap GEMM on
`csrc/wgmma_gemm.cuh`. The JAX package folds the statistics outside its
kernel into per-(B, C) scale/shift; `gn_fold` is that fold in plain torch
(two-pass variance), the statistics' plain version.

`fused_gn_silu_tconv` is the wrapper: on a CPU (or meta) tensor it runs
`plain_gn_silu_tconv` (the JAX `_xla_math`); on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from ..utils import profiling
from .norms import gn_plan_card

# The JAX dispatch admits c < 640 only (C = 640 measured slower than XLA on
# the TPU); the port keeps the same sites.
MAX_C = 639

launches = 0


class PackedTConv(NamedTuple):
    wcat: torch.Tensor   # (C, 3C) bf16, wcat[o, tap*C + i] = W[o, i, tap]
    bias: torch.Tensor   # (C,) fp32
    gn_w: torch.Tensor   # (C,) fp32, the GroupNorm's weight
    gn_b: torch.Tensor   # (C,) fp32, and bias


@torch.no_grad()
def pack_tconv(conv, norm) -> PackedTConv:
    """conv: Conv3d module with weight (C, C, 3, 1, 1); norm: the GroupNorm
    before it."""
    w = conv.weight
    c = w.shape[0]
    wcat = w[..., 0, 0].permute(0, 2, 1).reshape(c, 3 * w.shape[1])
    bias = conv.bias if conv.bias is not None else w.new_zeros(c)
    return PackedTConv(wcat.to(torch.bfloat16).contiguous(), bias.float().contiguous(),
                       norm.weight.float().contiguous(), norm.bias.float().contiguous())


def eligible(shape, dtype, weight_shape) -> bool:
    """Dispatch predicate for a video of `shape` (B, T, H, W, C) and a conv
    weight of `weight_shape`."""
    if len(shape) != 5:
        return False
    c = shape[-1]
    return (dtype == torch.bfloat16 and tuple(weight_shape) == (c, c, 3, 1, 1)
            and c <= MAX_C and c % 32 == 0 and shape[1] >= 2)


def gn_fold(norm, x, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm statistics and affine folded into per-(B, C) fp32 scale and
    shift, y = x * scale + shift, with the centered (two-pass) variance
    (tconv.py:49-70: the one-pass form goes negative under cancellation)."""
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    xf = x.float()
    cnt = xf[0].numel() // g

    def group_mean(per_channel):  # (B, C) -> (B, C) broadcast group means
        gsum = per_channel.reshape(b, g, c // g).sum(-1, keepdim=True)
        return (gsum / cnt).expand(b, g, c // g).reshape(b, c)

    mean = group_mean(xf.sum((1, 2, 3)))
    centered = xf - mean[:, None, None, None, :]
    var = group_mean((centered * centered).sum((1, 2, 3)))
    scale = torch.rsqrt(var + eps) * norm.weight.float()
    shift = norm.bias.float() - mean * scale
    return scale.contiguous(), shift.contiguous()


def plain_gn_silu_tconv(x, norm, conv):
    """Reference math: temporal conv(SiLU(GroupNorm(x)))."""
    from ..nn import functional as F

    return F.temporal_conv311(conv, F.silu(F.group_norm(norm, x)))


def fused_gn_silu_tconv(x, norm, conv, packed: PackedTConv | None = None):
    """GN -> SiLU -> temporal conv (3,1,1) over x (B, T, H, W, C)."""
    global launches
    if x.device.type in ("cpu", "meta"):
        return plain_gn_silu_tconv(x, norm, conv)
    if packed is None:
        raise RuntimeError("gn_silu_tconv: kernel weights not prepared "
                           "(call mudg_tpu_torch.kernels.prepare_kernels)")
    if not eligible(x.shape, x.dtype, conv.weight.shape):
        raise ValueError(f"gn_silu_tconv: unsupported input {tuple(x.shape)} {x.dtype}")
    b, t, h, w, c = x.shape
    _build.require(x, "x")
    _build.require(packed.wcat, "wcat")
    for name in ("bias", "gn_w", "gn_b"):
        _build.require(getattr(packed, name), name, torch.float32)
    if (tuple(packed.wcat.shape) != (c, 3 * c)
            or any(tuple(v.shape) != (c,) for v in packed[1:])):
        raise ValueError("gn_silu_tconv: packed weights do not match the input")
    rows = t * h * w
    plan = gn_plan_card(b, rows, c, 2, 32, True)
    lib = _build.load()
    out = torch.empty_like(x)
    hs = torch.empty_like(x)   # silu(GN(x)), the GEMM's A
    part = (None if plan.cluster else
            torch.empty(b * plan.chunks * 32 * 2, device=x.device, dtype=torch.float32))
    P = _build.ptr
    with profiling.span("kernel.gn_silu_tconv"):
        err = lib.mudg_gn_silu_tconv(P(x), P(out), P(hs), P(part), P(packed.gn_w),
                                     P(packed.gn_b), P(packed.wcat), P(packed.bias), b, t, h * w,
                                     c, plan.cluster, plan.per, plan.keep, plan.chunks,
                                     _build.stream())
    _build.check(err, "gn_silu_tconv")
    launches += 1
    return out
