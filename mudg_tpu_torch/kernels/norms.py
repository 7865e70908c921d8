"""Kernel 11: GroupNorm and LayerNorm with fp32 statistics (CUDA, `csrc/norms.cu`).

GroupNorm over a channels-last (N, *spatial, C) tensor, statistics over every
non-batch position of each of G channel groups; LayerNorm over the last axis
of (B, L, C). Both take bf16 or fp32, compute in fp32 and write x's dtype.
Replace `mudg_tpu/kernels/norms.py`'s `_gn_kernel` (pallas_call at :87) and
`_ln_kernel` (:172); the design note is at the top of the .cu file.

The dispatch (`nn/functional.group_norm` / `layer_norm`) takes them where the
JAX package takes its Pallas kernels: under `MUDG_FUSED_NORMS=1`, for a
tensor the fit predicates below admit (exact copies of the JAX ones, so the
sites are the same), in inference and training alike (the JAX dispatch
ignores `impl`).

`fused_group_norm` and `fused_layer_norm` are the wrappers: on a CPU (or
meta) tensor they run `plain_group_norm` / `plain_layer_norm`; on a CUDA
tensor they launch the kernel or raise. `group_norm_op` / `layer_norm_op`
are the ops with a gradient, whose backward is autograd of the plain math
(the JAX backward is `jax.vjp` of its XLA reference, :125-128, :204-207).

Known difference: the Pallas GroupNorm takes the one-pass variance
E[x^2] - E[x]^2 (norms.py:62-68), which cancels when |mean| >> std; the
plain version and the kernel here take the centered variance, as the JAX
reference `_gn_reference` and the JAX tconv statistics do.
"""
from __future__ import annotations

import torch

from . import _build

# per-program VMEM working set cap of the TPU kernels (input + output + fp32
# temps head-room); kept so that the port dispatches at the JAX sites
VMEM_SAMPLE_BYTES = 6 * 1024 * 1024
MAX_C = 4096    # widest channel axis the kernels take

launches = 0      # GroupNorm kernel launches
ln_launches = 0   # LayerNorm kernel launches


def group_norm_fits(x) -> bool:
    """`mudg_tpu/kernels/norms.py:group_norm_fits`: one sample (+ fp32
    temps) within the TPU kernel's VMEM budget."""
    if x.ndim < 3:
        return False
    n = x[0].numel()
    return n * x.element_size() * 2 + n * 4 <= VMEM_SAMPLE_BYTES * 2


def _pick_rows(l: int, c: int, itemsize: int) -> int:
    budget_rows = max(VMEM_SAMPLE_BYTES // max(c * (itemsize + 4), 1), 8)
    r = 1
    for cand in (2048, 1024, 512, 256, 128, 64, 32, 16, 8):
        if l % cand == 0 and cand <= budget_rows:
            r = cand
            break
    return r


def layer_norm_fits(x) -> bool:
    """`mudg_tpu/kernels/norms.py:layer_norm_fits`: (B, L, C) with a row
    block of at least 8."""
    if x.ndim != 3:
        return False
    return _pick_rows(x.shape[1], x.shape[-1], x.element_size()) >= 8


def plain_group_norm(x, w, b, groups: int, eps: float, *, one_pass=False, shift_groups=0):
    """`_gn_reference` (norms.py:101-113), the port's one GroupNorm formula
    (`nn/functional.group_norm` runs it off the kernel): statistics over
    each group of C // groups channels and every non-batch position in fp32
    (float64 for a float64 x), centered variance, output in x's dtype. The
    centered values are corrected by their own mean (the rounding of a mean
    far from 0: at a DC offset of 1e3 an fp32 mean is off by up to 3e-5),
    as the kernel's statistics around each group's first element are.
    `one_pass` (the Pallas kernel's E[x^2] - E[x]^2) and `shift_groups` (the
    channel-to-group map shifted by that many channels) are planted faults
    for the checks."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    wf, bf = w.to(xf.dtype), b.to(xf.dtype)
    n, c = xf.shape[0], xf.shape[-1]
    g = groups
    assert c % g == 0, f"channels {c} not divisible by groups {g}"
    if shift_groups:
        xf, wf, bf = (t.roll(-shift_groups, dims=-1) for t in (xf, wf, bf))
    dims = tuple(range(1, xf.ndim - 1))
    count = c // g
    for d in xf.shape[1:-1]:
        count *= d

    def group_mean(per_channel):  # (N, C) -> (N, *1, C) broadcast group means
        gsum = per_channel.reshape(n, g, c // g).sum(-1, keepdim=True)
        return (gsum / count).expand(n, g, c // g).reshape((n,) + (1,) * len(dims) + (c,))

    mean = group_mean(xf.sum(dims))
    centered = xf - mean
    corr = group_mean(centered.sum(dims))
    if one_pass:
        var = group_mean((xf * xf).sum(dims)) - mean * mean
    else:
        var = group_mean((centered * centered).sum(dims)) - corr * corr
    scale = torch.rsqrt(var + eps) * wf
    y = torch.addcmul(bf - corr * scale, centered, scale)
    if shift_groups:
        y = y.roll(shift_groups, dims=-1)
    return y.to(x.dtype)


def plain_layer_norm(x, w, b, eps: float, *, center=True):
    """`_ln_reference` (norms.py:186-192), the port's one LayerNorm formula
    (`nn/functional.layer_norm` runs it off the kernel): mean and centered
    variance over the last axis in fp32, output in x's dtype. `center=False`
    (no mean subtraction) is a planted fault for the checks."""
    xf = x.float()
    if center:
        y = torch.nn.functional.layer_norm(xf, (xf.shape[-1],), w.float(), b.float(), eps)
    else:
        var = xf.var(dim=-1, correction=0, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * w.float() + b.float()
    return y.to(x.dtype)


def _operands(x, w, b, name):
    """x as a contiguous CUDA tensor the kernels take, w and b as fp32."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: expected bf16 or fp32, got {x.dtype}")
    c = x.shape[-1]
    if c % 8 or c > MAX_C:
        raise ValueError(f"{name}: channels must be a multiple of 8 up to {MAX_C}, got {c}")
    x = x.contiguous()
    _build.require(x, name, x.dtype)
    w, b = (t.float().contiguous() for t in (w, b))
    if w.shape != (c,) or b.shape != (c,):
        raise ValueError(f"{name}: weight and bias must be ({c},)")
    return x, w, b


def fused_group_norm(x, w, b, groups: int = 32, eps: float = 1e-5):
    """GroupNorm of x (N, *spatial, C) with `groups` groups -> x's dtype."""
    global launches
    if x.device.type in ("cpu", "meta"):
        return plain_group_norm(x, w, b, groups, eps)
    if x.ndim < 3 or x.shape[-1] % groups:
        raise ValueError(f"fused_group_norm: unsupported shape {tuple(x.shape)}, "
                         f"groups {groups}")
    x, w, b = _operands(x, w, b, "fused_group_norm")
    c = x.shape[-1]
    n, rows = x.shape[0], x[0].numel() // c
    chunks, rows_per_chunk = gn_chunks(n, rows, c)
    y = torch.empty_like(x)
    part = torch.empty(n * chunks * groups * 2, device=x.device, dtype=torch.float32)
    lib = _build.load()
    P = _build.ptr
    err = lib.mudg_group_norm(P(x), P(y), P(w), P(b), P(part), n, rows, c, groups,
                              rows_per_chunk, chunks, int(x.dtype == torch.float32),
                              float(eps), _build.stream())
    _build.check(err, "fused_group_norm")
    launches += 1
    return y


# blocks the statistics pass aims for (four per SM of the H100's 132), and the
# most chunks a sample is cut into (the second pass folds them per group)
GN_TARGET_BLOCKS = 4 * 132
GN_MAX_CHUNKS = 64


def gn_chunks(n: int, rows: int, c: int) -> tuple[int, int]:
    """(chunks, rows per chunk) that cut each sample's `rows` positions so
    that the n * chunks blocks fill the card, each thread walking at least
    four rows (a block covers C // 8 channels x k rows per step)."""
    k = max(1, 256 // (c // 8))
    want = min(GN_MAX_CHUNKS, -(-GN_TARGET_BLOCKS // n), max(1, rows // (4 * k)))
    per = -(-rows // max(want, 1))
    return -(-rows // per), per


def fused_layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm over the last axis of x -> x's dtype."""
    global ln_launches
    if x.device.type in ("cpu", "meta"):
        return plain_layer_norm(x, w, b, eps)
    x, w, b = _operands(x, w, b, "fused_layer_norm")
    c = x.shape[-1]
    y = torch.empty_like(x)
    lib = _build.load()
    P = _build.ptr
    err = lib.mudg_layer_norm(P(x), P(y), P(w), P(b), x.numel() // c, c,
                              int(x.dtype == torch.float32), float(eps),
                              _build.stream())
    _build.check(err, "fused_layer_norm")
    ln_launches += 1
    return y


def _plain_vjp(fn, saved, needs, g):
    """Gradients of fn(*saved) for the upstream g, by autograd of the plain
    math (recomputed), None where no gradient is needed."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        y = fn(*ins)
        want = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(y, want, g)) if want else iter(())
    return [next(got) if t.requires_grad else None for t in ins]


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, groups, eps):
        ctx.save_for_backward(x, w, b)
        ctx.groups, ctx.eps = groups, eps
        return fused_group_norm(x, w, b, groups, eps)

    @staticmethod
    def backward(ctx, g):
        fn = lambda x, w, b: plain_group_norm(x, w, b, ctx.groups, ctx.eps)  # noqa: E731
        return (*_plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:3], g), None, None)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w, b)
        ctx.eps = eps
        return fused_layer_norm(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        fn = lambda x, w, b: plain_layer_norm(x, w, b, ctx.eps)  # noqa: E731
        return (*_plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:3], g), None)


def group_norm_op(x, w, b, groups: int = 32, eps: float = 1e-5):
    """`fused_group_norm` with the plain math's gradient to x, w and b."""
    return _GroupNorm.apply(x, w, b, groups, eps)


def layer_norm_op(x, w, b, eps: float = 1e-5):
    """`fused_layer_norm` with the plain math's gradient to x, w and b."""
    return _LayerNorm.apply(x, w, b, eps)
