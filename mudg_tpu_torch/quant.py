"""Post-training int8 quantization for serving (port of `mudg_tpu/quant.py`).

Scheme (W8A8 dynamic, as in the JAX package):
  * weights: symmetric per-output-channel int8, absmax calibration (or a
    percentile with `clip_pct`); a quantized layer holds `weight_i8` (W8A8)
    or `weight_q8` (weight-only), int8 in the torch layout (out, in, k...),
    and `scale`, fp32 (out,), in place of its `weight` Parameter; `bias`
    stays;
  * activations: dynamic symmetric int8 at product time, per row (the last
    axis) for linears and the (3,1,1) temporal convs' taps, per tensor for
    spatial convs (an output pixel mixes several input rows). The per-tensor
    scale spans the whole batch, as JAX's does: under CFG the cond and
    uncond halves, and a 3-task window's six samples, share one absmax;
  * products accumulate exactly in int32: `torch._int_mm` for linears and
    the temporal taps, and for a spatial conv the int32 sum of one
    `torch._int_mm` per kernel tap over the padded, strided int8 input
    (JAX's `lax.dot_general` / `lax.conv_general_dilated` with
    `preferred_element_type=int32`: plain XLA ops, no Pallas kernel). Every
    product goes through `int_mm`, which pads to the sizes the CUDA
    `_int_mm` takes; a product never falls back to a float path.

Numerics kept from JAX: fp32 scales, round half to even, codes clipped to
+-127, `acc.f32 * (x_scale * w_scale) + bias.f32` cast to the input dtype,
and the weight-only dequantization in the activation dtype (int8 and scale
each cast first, then multiplied). JAX keeps its parameters fp32 and casts
at application, so a quantized layer keeps `scale` and `bias` fp32 under
`module.to(dtype)` (the `QuantizedLayer` mixin); the int8 buffers stay int8
as `to(dtype)` casts floats only.

Layer selection (`quantize_module`) reads the torch shapes: the output
channel is axis 0 (JAX's -1), a temporal conv has `weight.shape[2:] == (3,
1, 1)` (JAX's `shape[:3]`), and a wide matmul's narrowest channel is
`min(out, in)`. JAX's `quantize_pytree(jit=)` only batches the conversion
into one XLA executable; the port converts eagerly and has no such argument.

Usage:
    quant.quantize_module(mdm.unet)          # before mdm.to(bf16) and prepare_kernels
    y = mdm.unet(x, t, ctx, ...)             # same call, int8 products inside
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

# Layers smaller than this stay in the original dtype (the quant/dequant
# overhead outweighs the traffic saved; the time-embed MLPs and norms are
# also the most precision-sensitive).
MIN_QUANT_SIZE = 65536
# "conv_wide" adds the matmuls whose narrowest channel is at least this
WIDE_MIN = 1024
W8A8, W8 = "weight_i8", "weight_q8"
# _int_mm on CUDA takes more than 16 rows and inner and output sizes that
# are multiples of 8
INT_MM_ROWS, INT_MM_ALIGN = 17, 8


def quantize_weight(w, axis: int = 0, clip_pct: float | None = None):
    """Symmetric per-output-channel int8 quantization of a weight.

    `axis` is the output-channel axis (0 in torch layouts). Returns (w_i8,
    scale) with w ~= w_i8 * scale broadcast on `axis`. clip_pct (e.g. 99.9):
    the scale from the clip_pct-th percentile of |w| within each channel
    (linear interpolation in fp32 as XLA evaluates jnp.percentile: the
    position from q * 0.01, the two weighted values summed with one fused
    multiply-add, emulated in fp64), weights beyond it saturating at +-127;
    None = exact absmax."""
    wf = w.float()
    ax = axis % wf.ndim
    shape = [1] * wf.ndim
    shape[ax] = wf.shape[ax]
    if clip_pct is None:
        amax = wf.abs().amax(dim=tuple(i for i in range(wf.ndim) if i != ax), keepdim=True)
    else:
        s = wf.abs().movedim(ax, 0).reshape(wf.shape[ax], -1).sort(dim=1).values
        f32 = torch.float32
        pos = torch.tensor(clip_pct, dtype=f32) * torch.tensor(0.01, dtype=f32) * (s.shape[1] - 1)
        hw = pos - pos.floor()
        low, high = s[:, int(pos.floor())], s[:, int(pos.ceil())]
        amax = (low.double() * (1 - hw).double() + (high * hw).double()).float().reshape(shape)
    scale = amax.clamp_min(1e-12) / 127.0
    w_i8 = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return w_i8, scale.reshape(wf.shape[ax])


class QuantizedLayer:
    """Mixin of a quantized Linear or Conv: its float tensors (`scale`,
    `bias`) stay fp32 whatever `module.to(dtype)` asks, as the JAX tree
    keeps them; device moves apply."""

    def _apply(self, fn, recurse=True):
        kept = {k: getattr(self, k).data for k in ("scale", "bias")
                if getattr(self, k, None) is not None}
        super()._apply(fn, recurse)
        for k, old in kept.items():
            new = getattr(self, k)
            if new.dtype != old.dtype:
                new.data = old.to(new.device)
        return self


_CLASSES: dict[type, type] = {}


def _quantized_class(cls):
    if issubclass(cls, QuantizedLayer):
        return cls
    if cls not in _CLASSES:
        _CLASSES[cls] = type("Quantized" + cls.__name__, (QuantizedLayer, cls), {})
    return _CLASSES[cls]


def is_float(m) -> bool:
    """The layer holds a float `weight` (JAX's `"weight" in p`): the kernel
    predicates admit only such layers."""
    return "weight" in m._parameters


def is_w8a8(m) -> bool:
    return W8A8 in m._buffers


def weight_shape(m) -> torch.Size:
    """The torch-layout shape of a layer's weight, quantized or not."""
    for k in (W8A8, W8):
        if k in m._buffers:
            return m._buffers[k].shape
    return m.weight.shape


def _set_quantized(m, key, w_i8, scale):
    del m.weight
    m.register_buffer(key, w_i8)
    m.register_buffer("scale", scale)
    m.__class__ = _quantized_class(type(m))


def _quantizable(m) -> bool:
    """A conv/linear leaf (JAX's `_is_quantizable_leaf_dict`): no child
    modules, no buffers, parameters `weight` (ndim >= 2) and maybe `bias`."""
    params = m._parameters
    return (not m._modules and not m._buffers and "weight" in params
            and set(params) <= {"weight", "bias"} and params["weight"].ndim >= 2)


def _spatial_conv(shape) -> bool:
    return len(shape) > 2 and tuple(shape[2:]) != (3, 1, 1)


def _wide_matmul(shape) -> bool:
    """A linear, or a (3,1,1) temporal conv (three shifted matmuls), whose
    narrowest channel is >= WIDE_MIN."""
    if len(shape) == 2:
        return min(shape) >= WIDE_MIN
    return tuple(shape[2:]) == (3, 1, 1) and min(shape[:2]) >= WIDE_MIN


@torch.no_grad()
def quantize_module(module, *, min_size: int | None = None, mode: str = "w8a8",
                    conv_mode: str | None = None, which: str = "all"):
    """Quantize, in place, every conv/linear layer of `module` (weight ndim
    >= 2, at least `min_size` elements, MIN_QUANT_SIZE by default) that
    `which` selects (`quantize_pytree`, quant.py:80-197), with absmax
    scales (no caller of the JAX package passes its `clip_pct`). Returns
    module.

    mode: "w8a8" (int8 weights and dynamic int8 activations, int32
    products) or "w8" (weight-only: int8 storage, dequantized to the
    activation dtype at application). conv_mode overrides mode for spatial
    convolutions (the (3,1,1) temporal convs run as matmuls and follow
    mode); the apps pass "w8" under sequence parallelism, as JAX does.
    which: "all"; "conv", spatial convolutions only (a 1x1 Conv1d
    projection counts, as its weight is 3-D); "conv_wide", "conv" plus the
    wide matmuls (`_wide_matmul`). Run it on fp32 weights (before the
    serving cast) and before `kernels.prepare_kernels`."""
    threshold = MIN_QUANT_SIZE if min_size is None else min_size
    assert mode in ("w8a8", "w8"), mode
    conv_mode = mode if conv_mode is None else conv_mode
    assert conv_mode in ("w8a8", "w8"), conv_mode
    assert which in ("all", "conv", "conv_wide"), which

    def selected(shape) -> bool:
        if which == "all":
            return True
        return _spatial_conv(shape) or (which == "conv_wide" and _wide_matmul(shape))

    picked = [m for m in module.modules()
              if _quantizable(m) and m.weight.numel() >= threshold and selected(m.weight.shape)]
    for m in picked:
        shape = m.weight.shape
        m_mode = conv_mode if _spatial_conv(shape) else mode
        w_i8, scale = quantize_weight(m.weight)
        _set_quantized(m, W8A8 if m_mode == "w8a8" else W8, w_i8, scale)
    return module


def quantize_like(module, state_dict) -> int:
    """Restructure `module`'s layers as a quantized state dict holds them
    (the `quantize` app's artifact): each layer with a `weight_i8` or
    `weight_q8` key is given those buffers, ready for `load_state_dict`.
    Returns the number of layers restructured."""
    n = 0
    for key, w in state_dict.items():
        name, _, leaf = key.rpartition(".")
        if leaf not in (W8A8, W8):
            continue
        m = module.get_submodule(name)
        if is_float(m):
            dev = m.weight.device
            _set_quantized(m, leaf, torch.empty(w.shape, dtype=torch.int8, device=dev),
                           torch.empty(w.shape[0], dtype=torch.float32, device=dev))
            n += 1
    return n


def conv_w8a8_to_w8(module) -> int:
    """Demote, in place, the W8A8 spatial conv layers to weight-only: a pure
    rename of `weight_i8` to `weight_q8` (both hold the same quantize_weight
    output; quant.py:200-224). The apps do it to a loaded artifact under
    sequence parallelism, as JAX does. Returns the number renamed."""
    n = 0
    for m in module.modules():
        if is_w8a8(m) and _spatial_conv(m.weight_i8.shape):
            m._buffers[W8] = m._buffers.pop(W8A8)
            n += 1
    return n


def dequantize_weight(m, dtype):
    """A weight-only layer's effective weight in `dtype`: the int8 codes and
    the scale each cast to `dtype`, then multiplied (quant.py:227-230)."""
    w = m.weight_q8
    return w.to(dtype) * m.scale.to(dtype).reshape(-1, *([1] * (w.ndim - 1)))


def size_report(module) -> dict:
    """Bytes by dtype class of every parameter and buffer of `module`."""
    int8 = other = 0
    for t in itertools.chain(module.parameters(), module.buffers()):
        nbytes = t.numel() * t.element_size()
        if t.dtype == torch.int8:
            int8 += nbytes
        else:
            other += nbytes
    return {"int8_bytes": int(int8), "other_bytes": int(other)}


# ---------------------------------------------------------------------------
# Quantized forwards (dispatched from nn/functional.py)
# ---------------------------------------------------------------------------

def int_mm(a, w):
    """a (M, K) int8 @ w.T, w (N, K) int8 -> (M, N) int32, exact.

    torch._int_mm with a row-major and w.T column-major; M is padded to at
    least 17 rows and K and N to multiples of 8 with zeros (which add
    nothing), the sizes its CUDA kernel takes; any other refusal raises."""
    m, k = a.shape
    n = w.shape[0]
    pk, pn, pm = -k % INT_MM_ALIGN, -n % INT_MM_ALIGN, max(0, INT_MM_ROWS - m)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if pm or pn else out


def _quantize_act(xf, amax):
    scale = amax.clamp_min(1e-12) / 127.0
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def _dyn_quant_rows(x):
    """Per-row (last axis) symmetric dynamic quantization: (x_i8, x_scale)
    with x ~= x_i8 * x_scale, x_scale (..., 1) fp32."""
    xf = x.float()
    return _quantize_act(xf, xf.abs().amax(dim=-1, keepdim=True))


def _dyn_quant_tensor(x):
    """Per-tensor symmetric dynamic quantization (the whole batch)."""
    xf = x.float()
    return _quantize_act(xf, xf.abs().amax())


def _dequant(acc, x_scale, m, dtype):
    y = acc.float() * (x_scale * m.scale)
    if m.bias is not None:
        y = y + m.bias.float()
    return y.to(dtype)


def linear_acc(m, x):
    """A W8A8 linear's int32 accumulator q(x) @ w_i8.T (..., out) and its
    per-row activation scales (..., 1). A 1x1 Conv1d's (out, in, 1) weight
    runs as the linear it is (attention.py's `_proj`)."""
    w = m.weight_i8.flatten(1)
    x_i8, x_scale = _dyn_quant_rows(x)
    acc = int_mm(x_i8.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[0])
    return acc, x_scale


def linear_i8(m, x):
    """W8A8 linear: y = (q(x) @ w_i8.T) * (x_scale * w_scale) + b."""
    return _dequant(*linear_acc(m, x), m, x.dtype)


def same_pads(size: int, k: int, stride: int):
    """XLA's "SAME" padding of one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_acc(m, x, *, stride=1, padding="SAME", groups: int = 1):
    """A W8A8 convolution's int32 accumulator (N, *out, O) and its one
    per-tensor activation scale, over channels-last x (N, *spatial, C) with
    1-3 spatial axes and the torch weight (O, C / groups, *k). padding:
    "SAME" (XLA's) or one (low, high) per spatial axis. The accumulator is
    the sum over the kernel taps of one `int_mm` per tap (and group) on the
    strided int8 input."""
    w = m.weight_i8
    ks = tuple(w.shape[2:])
    nd = len(ks)
    strides = (stride,) * nd if isinstance(stride, int) else tuple(stride)
    pads = ([same_pads(x.shape[1 + i], ks[i], strides[i]) for i in range(nd)]
            if padding == "SAME" else [tuple(p) for p in padding])
    x_i8, x_scale = _dyn_quant_tensor(x)
    spec = [0, 0]
    for lo, hi in reversed(pads):
        spec += [lo, hi]
    xp = F.pad(x_i8, spec)
    out = [(xp.shape[1 + i] - ks[i]) // strides[i] + 1 for i in range(nd)]
    cg, og = w.shape[1], w.shape[0] // groups
    taps = w.permute(*range(2, 2 + nd), 0, 1)   # (*k, O, C / groups)
    acc = None
    for tap in itertools.product(*(range(k) for k in ks)):
        win = xp[(slice(None),) + tuple(slice(t, t + (o - 1) * s + 1, s)
                                        for t, o, s in zip(tap, out, strides))]
        rows = win.reshape(-1, win.shape[-1])
        wt = taps[tap]
        part = (int_mm(rows, wt) if groups == 1 else
                torch.cat([int_mm(rows[:, g * cg:(g + 1) * cg], wt[g * og:(g + 1) * og])
                           for g in range(groups)], dim=1))
        acc = part if acc is None else acc + part
    return acc.reshape(x.shape[0], *out, w.shape[0]), x_scale


def conv_i8(m, x, *, stride=1, padding="SAME", groups: int = 1):
    """W8A8 convolution with one per-tensor activation scale (`conv_acc`)."""
    return _dequant(*conv_acc(m, x, stride=stride, padding=padding, groups=groups), m, x.dtype)


def temporal_accs(m, x):
    """A W8A8 (3,1,1) temporal conv's three int32 tap accumulators over x
    (N, T, H, W, C) (tap 0 over frames :-1, tap 1 over all, tap 2 over 1:)
    and the per-row activation scales (N, T, H, W, 1)."""
    w = m.weight_i8
    assert tuple(w.shape[2:]) == (3, 1, 1), w.shape
    x_i8, x_scale = _dyn_quant_rows(x)

    def tap(xi, t):
        return int_mm(xi.reshape(-1, xi.shape[-1]), w[:, :, t, 0, 0]).reshape(
            *xi.shape[:-1], w.shape[0])

    return (tap(x_i8[:, :-1], 0), tap(x_i8, 1), tap(x_i8[:, 1:], 2)), x_scale


def temporal_conv311_i8(m, x):
    """(3,1,1) temporal conv over x (N, T, H, W, C) as three shifted int8
    matmuls with per-row activation scales, each tap scaled by its own input
    rows' scales (quant.py:295-318)."""
    (a0, a1, a2), x_scale = temporal_accs(m, x)
    s = x_scale * m.scale   # (..., 1) * (out,) -> (..., out)
    y = a1.float() * s
    y = y + F.pad(a0.float() * s[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0))
    y = y + F.pad(a2.float() * s[:, 1:], (0, 0, 0, 0, 0, 0, 0, 1))
    if m.bias is not None:
        y = y + m.bias.float()
    return y.to(x.dtype)
