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
tensor they launch the kernel or raise. They pass w and b as stored (bf16
or fp32). The GroupNorm launches by the plan `gn_plan` makes once per shape
(one thread-block cluster per sample, or the two passes); the LayerNorm's
C launcher plans for itself (the row or the tile kernel), as it does for
kernels 1, 2, 3 and 9. `group_norm_op` / `layer_norm_op` are the ops with a
gradient, whose backward is autograd of the plain math (the JAX backward
is `jax.vjp` of its XLA reference, :125-128, :204-207); where no gradient
is wanted they call the wrappers alone.

Known difference: the Pallas GroupNorm takes the one-pass variance
E[x^2] - E[x]^2 (norms.py:62-68), which cancels when |mean| >> std; the
plain version and the kernel here take the centered variance, as the JAX
reference `_gn_reference` and the JAX tconv statistics do.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from ..nn import remat as R

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


def plain_group_norm(x, w, b, groups: int, eps: float, *, one_pass=False, shift_groups=0,
                     allsum=None):
    """`_gn_reference` (norms.py:101-113), the port's one GroupNorm formula
    (`nn/functional.group_norm` runs it off the kernel): statistics over
    each group of C // groups channels and every non-batch position in fp32
    (float64 for a float64 x), centered variance, output in x's dtype. The
    centered values are corrected by their own mean (the rounding of a mean
    far from 0: at a DC offset of 1e3 an fp32 mean is off by up to 3e-5),
    as the kernel's statistics around each group's first element are.
    `one_pass` (the Pallas kernel's E[x^2] - E[x]^2) and `shift_groups` (the
    channel-to-group map shifted by that many channels) are planted faults
    for the checks. `allsum` (a differentiable sum over the ranks that each
    hold a block of the positions, `parallel/sp.stats_sum`) makes the
    statistics those of the whole: the per-channel sums with the element
    count in one call, then the centered sums and squares in another."""
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

    if allsum is None:
        s1 = xf.sum(dims)
    else:
        # the element count rides the first sum: blocks may differ in size
        both = allsum(torch.cat([xf.sum(dims), xf.new_full((n, 1), float(count))], 1))
        s1, count = both[:, :c], both[:, c:].reshape(n, 1, 1)
    mean = group_mean(s1)
    centered = xf - mean
    if allsum is None:
        s_c = centered.sum(dims)
        s_q = (xf * xf if one_pass else centered * centered).sum(dims)
    else:
        s_c, s_q = allsum(torch.stack([centered.sum(dims),
                                       (xf * xf if one_pass else centered * centered)
                                       .sum(dims)])).unbind(0)
    corr = group_mean(s_c)
    if one_pass:
        var = group_mean(s_q) - mean * mean
    else:
        var = group_mean(s_q) - corr * corr
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


# Launch planning (the kernels' rules, `csrc/norms.cu`): shared memory a
# block may use and an SM holds (each block also reserves 1 KB), the
# GroupNorm cluster's largest size, its bulk copies per slab, and the CTAs
# in flight past which gn_plan takes no more (any count from 81 to 96 gives
# the same plan at every shape of chip_smoke.py's GN_SHAPES, the plans
# tests/test_torch_norm_plan.py pins and PERF.md's times were taken with).
SMEM_MAX = 232448
SM_SMEM = 233472
GN_MAX_CLUSTER = 16
GN_PIECES = 8
GN_FILL_CTAS = 88
# the two-pass GroupNorm's blocks (four per SM of the H100's 132) and the
# most chunks a sample is cut into
GN_TARGET_BLOCKS = 4 * 132
GN_MAX_CHUNKS = 128


def gn_threads(c: int) -> int:
    """Threads of a GroupNorm block: one per 8 channels of a row times
    max(1, 256 // (C / 8)) rows per step."""
    tpr = c // 8
    return tpr * max(1, 256 // tpr)


def gn_cluster_smem(per: int, c: int, itemsize: int, groups: int) -> int:
    """Shared memory of a cluster CTA: its slab of `per` rows, GN_PIECES
    mbarriers, two (mean, M2) partials per thread, two float4 per group."""
    return per * c * itemsize + 8 * GN_PIECES + 16 * gn_threads(c) + 32 * groups


class GNPlan(NamedTuple):
    cluster: int   # CTAs per cluster, one cluster per sample; 0: the two passes
    per: int       # rows per CTA (cluster) or per chunk (two passes)
    keep: int      # rows of a CTA held in shared memory (0: two passes)
    chunks: int    # CTAs (cluster) or chunks per sample
    smem: int      # a cluster CTA's shared memory (0: two passes)


def gn_chunks(n: int, rows: int, c: int) -> tuple[int, int]:
    """(chunks, rows per chunk) of the two-pass GroupNorm: each sample's `rows`
    cut so that the n * chunks blocks fill the card, each thread walking at
    least four rows."""
    k = gn_threads(c) // (c // 8)
    want = min(GN_MAX_CHUNKS, -(-GN_TARGET_BLOCKS // n), max(1, rows // (4 * k)))
    per = -(-rows // want)
    return -(-rows // per), per


def gn_plan(n: int, rows: int, c: int, itemsize: int, groups: int = 32, silu: bool = False,
            active=None) -> GNPlan:
    """The GroupNorm's launch for n samples of rows x c: one cluster per
    sample where a cluster's CTAs can hold it in shared memory (C / groups
    >= 8, the channels of a thread), else the two passes.
    `active(cluster, c, smem, itemsize, silu)` is the number of clusters
    the card holds at once (cudaOccupancyMaxActiveClusters; None: ask the
    card). Each size 1..16 is taken with its CTAs holding all their rows,
    where that fits SMEM_MAX, and holding what lets two CTAs share an SM
    (the rest read again after the statistics); the plan is the first by
    the fewest waves of clusters, then the most CTAs in flight up to
    GN_FILL_CTAS, then the fewest rows read again, then the smallest size."""
    active = active or _card_clusters
    row_bytes = c * itemsize
    splits = [(cs, -(-rows // cs)) for cs in range(1, GN_MAX_CLUSTER + 1)
              if -(-rows // -(-rows // cs)) == cs]   # no size whose split a smaller one has
    if c // groups < 8 or all(gn_cluster_smem(per, c, itemsize, groups) > SMEM_MAX
                              for _, per in splits):
        chunks, per = gn_chunks(n, rows, c)
        return GNPlan(0, per, 0, chunks, 0)
    # rows a CTA holds to share an SM with another (blocks of up to 256
    # threads fit two an SM by registers; wider ones hold all their rows)
    half = ((SM_SMEM // 2 - 1024 - gn_cluster_smem(0, c, itemsize, groups)) // row_bytes
            if gn_threads(c) <= 256 else 0)
    best = None
    for cs, per in splits:
        keeps = [k for k in (per, min(per, half)) if k >= 1
                 and gn_cluster_smem(k, c, itemsize, groups) <= SMEM_MAX]
        for keep in dict.fromkeys(keeps):
            smem = gn_cluster_smem(keep, c, itemsize, groups)
            clusters = active(cs, c, smem, itemsize, silu)
            if clusters < 1:
                continue
            key = (-(-n // clusters), -min(GN_FILL_CTAS, min(n, clusters) * cs), per - keep, cs)
            if best is None or key < best[0]:
                best = (key, GNPlan(cs, per, keep, cs, smem))
    if best is None:
        chunks, per = gn_chunks(n, rows, c)
        return GNPlan(0, per, 0, chunks, 0)
    return best[1]


@functools.lru_cache(maxsize=None)
def _card_clusters(cs, c, smem, itemsize, silu):
    out = ctypes.c_int(0)
    err = _build.load().mudg_gn_max_clusters(cs, c, smem, int(itemsize == 4), int(silu),
                                             ctypes.addressof(out))
    _build.check(err, "mudg_gn_max_clusters")
    return out.value


# gn_plan on this card, once per shape (kernel 4 plans its GroupNorm here too)
gn_plan_card = functools.lru_cache(maxsize=None)(gn_plan)


def plan_text(kind: str, x) -> str:
    """The launch the wrapper takes for x, as text ("plain" off the card):
    the GroupNorm's `gn_plan`, the LayerNorm's from its C launcher
    (`mudg_ln_plan`, `csrc/norms.cu:ln_plan`)."""
    if x.device.type != "cuda":
        return "plain"
    c, itemsize = x.shape[-1], x.element_size()
    if kind == "group_norm":
        n = x.shape[0]
        p = gn_plan_card(n, x.numel() // (n * c), c, itemsize)
        if p.cluster:
            held = _card_clusters(p.cluster, c, p.smem, itemsize, False)
            return (f"cluster {p.cluster} x {p.per} rows ({p.keep} held), {p.smem} B, "
                    f"{held} clusters at once")
        return f"two-pass {p.chunks} x {p.per} rows"
    tile, team, vpt, threads, tile_rows, smem, grid = ln_plan_card(x.numel() // c, c, itemsize)
    if tile:
        return (f"tiles: team {team} x {vpt} chunks, {threads} threads, tiles of {tile_rows} "
                f"rows, {smem} B, grid {grid}")
    return f"rows: team {team} x {vpt} vectors, grid {grid}"


def ln_plan_card(rows: int, c: int, itemsize: int) -> tuple[int, ...]:
    """The C launcher's LayerNorm plan (`csrc/norms.cu:mudg_ln_plan`): tile
    (1: the persistent tile kernel, 0: the row kernel), team, chunks or
    vectors a lane, threads, tile rows, shared memory, grid."""
    got = (ctypes.c_int * 7)()
    err = _build.load().mudg_ln_plan(rows, c, int(itemsize == 4), ctypes.addressof(got))
    _build.check(err, "mudg_ln_plan")
    return tuple(got)


def _checked(x, w, b, name):
    """x contiguous, bf16 or fp32 on the card (`_build.require`), C % 8 == 0
    up to MAX_C; w and b (C,) on x's device, passed as stored where both are
    bf16 or fp32, contiguous and 16-byte aligned (wbf = 1 for bf16), else
    cast to fp32 once."""
    x = x.contiguous()
    _build.require(x, name, (torch.bfloat16, torch.float32))
    c = x.shape[-1]
    if c % 8 or c > MAX_C:
        raise ValueError(f"{name}: channels must be a multiple of 8 up to {MAX_C}, got {c}")
    if w.shape != (c,) or b.shape != (c,):
        raise ValueError(f"{name}: weight and bias must be ({c},)")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"{name}: weight and bias must be on {x.device}")
    if not (w.dtype == b.dtype and w.dtype in (torch.bfloat16, torch.float32)
            and w.is_contiguous() and b.is_contiguous()
            and w.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0):
        w, b = w.float().contiguous(), b.float().contiguous()
    return x, w, b, int(w.dtype == torch.bfloat16)


def fused_group_norm(x, w, b, groups: int = 32, eps: float = 1e-5):
    """GroupNorm of x (N, *spatial, C) with `groups` groups -> x's dtype."""
    global launches
    if x.device.type in ("cpu", "meta"):
        return plain_group_norm(x, w, b, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: expected a CUDA tensor, got {x.device}")
    if x.ndim < 3 or x.shape[-1] % groups:
        raise ValueError(f"fused_group_norm: unsupported shape {tuple(x.shape)}, "
                         f"groups {groups}")
    x, w, b, wbf = _checked(x, w, b, "fused_group_norm")
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    plan = gn_plan_card(n, rows, c, x.element_size(), groups)
    y = torch.empty_like(x)
    part = (None if plan.cluster else
            torch.empty(n * plan.chunks * groups * 2, device=x.device, dtype=torch.float32))
    P = _build.ptr
    err = _build.load().mudg_group_norm(
        P(x), P(y), P(w), P(b), P(part), wbf, n, rows, c, groups, plan.cluster, plan.per,
        plan.keep, plan.chunks, int(x.dtype == torch.float32), eps, _build.stream(x.device))
    _build.check(err, "fused_group_norm")
    launches += 1
    return y


def fused_layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm over the last axis of x -> x's dtype."""
    global ln_launches
    if x.device.type in ("cpu", "meta"):
        return plain_layer_norm(x, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: expected a CUDA tensor, got {x.device}")
    x, w, b, wbf = _checked(x, w, b, "fused_layer_norm")
    c = x.shape[-1]
    y = torch.empty_like(x)
    P = _build.ptr
    err = _build.load().mudg_layer_norm_w(
        P(x), P(y), P(w), P(b), wbf, x.numel() // c, c, int(x.dtype == torch.float32), -1,
        eps, _build.stream(x.device))
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
        # gn_out (nn/functional.group_norm tags it): kept by the gn_out policies
        return R.kernel_outputs((("gn_out",),),
                                lambda: (fused_group_norm(x, w, b, groups, eps),))[0]

    @staticmethod
    def backward(ctx, g):
        fn = lambda x, w, b: plain_group_norm(x, w, b, ctx.groups, ctx.eps)  # noqa: E731
        return (*_plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:3], g), None, None)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w, b)
        ctx.eps = eps
        # no tag on the JAX fused-LN path: only remat="except_ff" keeps it
        return R.kernel_outputs((), lambda: (fused_layer_norm(x, w, b, eps),))[0]

    @staticmethod
    def backward(ctx, g):
        fn = lambda x, w, b: plain_layer_norm(x, w, b, ctx.eps)  # noqa: E731
        return (*_plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:3], g), None)


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def group_norm_op(x, w, b, groups: int = 32, eps: float = 1e-5):
    """`fused_group_norm` with the plain math's gradient to x, w and b; the
    wrapper alone where no gradient is wanted (grad disabled, or no input
    requires one)."""
    if not _wants_grad(x, w, b):
        return fused_group_norm(x, w, b, groups, eps)
    return _GroupNorm.apply(x, w, b, groups, eps)


def layer_norm_op(x, w, b, eps: float = 1e-5):
    """`fused_layer_norm` with the plain math's gradient to x, w and b; the
    wrapper alone where no gradient is wanted."""
    if not _wants_grad(x, w, b):
        return fused_layer_norm(x, w, b, eps)
    return _LayerNorm.apply(x, w, b, eps)
