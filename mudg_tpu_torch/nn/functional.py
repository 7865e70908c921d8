"""Functional NN primitives on channels-last tensors.

Port of `mudg_tpu/nn/functional.py`. Layers are plain functions of a module
that holds `weight`/`bias` in torch layouts (Linear (out, in), ConvNd
(out, in, k...)), applied to channels-last activations: (N, H, W, C)
spatial, (N, T, H, W, C) video. Forwards run in the dtype of their input;
weights are cast to it at application. GroupNorm and LayerNorm are fp32
islands (cast up, normalize, cast back), as in the reference. Under
`MUDG_FUSED_NORMS=1` a CUDA tensor that the JAX fit predicates admit goes to
kernel 11 (`kernels/norms.py`), whatever the caller's `impl`, as the JAX
dispatch sends it to its Pallas kernels (nn/functional.py:166-193,
:226-233); the JAX dispatch's "backend is TPU" is "the tensor is on CUDA"
here.

Each layer runs inside the tag site the JAX package names its output by
(`checkpoint_name`, read by the remat policies of `nn/remat.py`): mm_out
(a linear, or the tag its caller gives), conv_out, tconv_out, gn_out and
ln_out; the kernel-11 LayerNorm carries no tag, as the JAX fused-LN path
(nn/functional.py:233) has none.

A layer that `quant.quantize_module` made int8 dispatches on its buffers as
the JAX layers dispatch on their leaves (nn/functional.py:38-151): a
`weight_i8` layer runs `quant.linear_i8`, `conv_i8` or
`temporal_conv311_i8` (a linear inside its caller's tag site; the int8
convs carry no tag, as in JAX), a `weight_q8` layer the float path on its
dequantized weight.

Two multi-GPU hooks: a Linear that `parallel/tp.py` cut over
the model ranks carries a `tp` role and runs through it, and a GroupNorm
given a sequence-parallel sharding sums its statistics over the seq ranks
(`parallel/sp.stats_sum`).
"""
from __future__ import annotations

import os

import torch.nn.functional as F

from .. import quant as Q
from ..kernels import norms as N
from . import remat as R


def on_card(x) -> bool:
    """Whether x lies where the port's kernels run (the JAX dispatch's
    backend check)."""
    return x.device.type == "cuda"


def _fused_norms(x) -> bool:
    return os.environ.get("MUDG_FUSED_NORMS") == "1" and on_card(x)


def _w(m, dtype):
    """The layer's weight in `dtype`, a weight-only layer's dequantized."""
    if Q.W8 in m._buffers:
        return Q.dequantize_weight(m, dtype)
    return m.weight.to(dtype)


def _b(m, dtype):
    return None if m.bias is None else m.bias.to(dtype)


def linear(m, x, tag: str = "mm_out"):
    """x (..., in) -> (..., out); `tag` names the output for the remat
    policies (the GEGLU inner passes "ff_inner", which they recompute). A
    1x1 Conv1d (weight (out, in, 1)) runs as the linear it is."""
    tp = getattr(m, "tp", None)
    if tp is not None:
        return tp.linear(m, x, tag)
    with R.site(tag):
        if Q.is_w8a8(m):
            return Q.linear_i8(m, x)
        return F.linear(x, _w(m, x.dtype).flatten(1), _b(m, x.dtype))


def conv2d(m, x, stride: int = 1, padding="SAME"):
    """x (N, H, W, C) -> (N, H', W', O). padding: "SAME" (k // 2 on every
    side, the stride-1 SAME of the JAX package) or ((top, bottom), (left, right))."""
    if Q.is_w8a8(m):
        return Q.conv_i8(m, x, stride=stride, padding=padding)
    with R.site("conv_out"):
        return _conv2d(m, x, stride, padding)


def _conv2d(m, x, stride, padding):
    kh, kw = Q.weight_shape(m)[-2:]
    xc = x.permute(0, 3, 1, 2)   # NCHW view with channels-last strides
    if padding == "SAME":
        pad = (kh // 2, kw // 2)
    else:
        (t, b_), (l, r) = padding
        if t == b_ and l == r:
            pad = (t, l)
        else:
            xc = F.pad(xc, (l, r, t, b_))
            pad = 0
    y = F.conv2d(xc, _w(m, x.dtype), _b(m, x.dtype), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def temporal_conv311(m, x):
    """(3,1,1) temporal conv with zero padding in t, as three shifted
    products (nn/functional.py:118-136). x (N, T, H, W, C); weight
    (out, in, 3, 1, 1)."""
    if Q.is_w8a8(m):
        return Q.temporal_conv311_i8(m, x)
    with R.site("tconv_out"):
        w = _w(m, x.dtype)
        assert w.shape[2:] == (3, 1, 1), w.shape
        w0, w1, w2 = w[:, :, 0, 0, 0], w[:, :, 1, 0, 0], w[:, :, 2, 0, 0]
        y = F.linear(x, w1)
        y = y + F.pad(F.linear(x[:, :-1], w0), (0, 0, 0, 0, 0, 0, 1, 0))
        y = y + F.pad(F.linear(x[:, 1:], w2), (0, 0, 0, 0, 0, 0, 0, 1))
        if m.bias is not None:
            y = y + _b(m, x.dtype)
        return y


def group_norm(m, x, num_groups: int = 32, eps: float = 1e-5, sp=None):
    """GroupNorm over channels-last input, stats over every non-batch dim of
    each channel group, in fp32 with the centered (two-pass) variance
    (nn/functional.py:180-223); kernel 11 under `MUDG_FUSED_NORMS=1` where
    it fits. sp: a sequence-parallel sharding whose ranks each hold a block
    of the positions; the statistics are then summed over its group, on the
    plain path."""
    if sp is not None:
        from ..parallel import sp as SP

        with R.site("gn_out"):
            return N.plain_group_norm(x, m.weight, m.bias, num_groups, eps,
                                      allsum=SP.stats_sum(sp))
    if _fused_norms(x) and N.group_norm_fits(x):
        R.tag("gn_out")
        return N.group_norm_op(x, m.weight, m.bias, num_groups, eps)
    with R.site("gn_out"):
        return N.plain_group_norm(x, m.weight, m.bias, num_groups, eps)


def layer_norm(m, x, eps: float = 1e-5):
    """LayerNorm over the last axis in fp32 (population variance); kernel 11
    under `MUDG_FUSED_NORMS=1` where it fits."""
    if _fused_norms(x) and N.layer_norm_fits(x):
        return N.layer_norm_op(x, m.weight, m.bias, eps)
    with R.site("ln_out"):
        return N.plain_layer_norm(x, m.weight, m.bias, eps)


def silu(x):
    return F.silu(x)


def gelu(x):
    """Exact erf GELU (torch.nn.GELU's default), as the reference pins."""
    return F.gelu(x, approximate="none")


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsampling over the (H, W) axes of (..., H, W, C)."""
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
