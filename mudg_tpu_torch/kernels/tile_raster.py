"""Kernel 13: front-to-back alpha compositing of sorted gaussian/tile pairs
per 16x16 tile (CUDA, `csrc/tile_raster.cu`), and its backward.

Replaces `mudg_tpu/gs/tile_raster.py`'s `_fwd_kernel` and `_bwd_kernel`
(the custom-vjp op `composite_tiles`).

Layout: `feats` (P, 6 + npay) f32, one row per pair [mux, muy, conic a, b,
c, opacity, payload...], sorted by (tile, depth); `bounds` (n_tiles + 1,)
i32. The output (n_tiles, npay + 1, 256) holds the payload sums and the
final transmittance per pixel; `last` (n_tiles, 256) i32 holds, per pixel,
1 + the index within its tile of the last pair that contributed.

On the H100 both directions are bound by FP32 instruction issue (about 14
operations and an exp per (pair, pixel) evaluation over a few bytes), and
by how long the heaviest tiles keep their blocks busy: pair counts differ
between tiles by orders of magnitude. So each kernel runs a persistent grid
that takes the tiles heaviest first (`tile_order`: the forward by pair
count, the backward by the tile's largest `last`; a sort inside the same
launch), gives each thread two pixels, streams each block's pair rows
through shared memory by bulk async copies and re-lays them into 16-byte
fields with a box per pair outside which alpha < 1/255 (a warp skips a
pair whose box misses its 8 x 8 quadrant); the backward sums each pair's
gradient terms over the warp by a reduce-scatter over groups of pairs.
Where an image has so few tiles that both halves of each fit on the card
at once, the forward takes half tiles, one pixel a thread. The note at the
top of the .cu file has the details.

`tile_composite` and `tile_composite_bwd` are the wrappers: on a CPU tensor
they run `plain_tile_composite` / `plain_tile_composite_bwd`; on a CUDA
tensor they launch the kernel or raise. `composite_tiles` is the op with a
gradient (a `torch.autograd.Function`).
"""
from __future__ import annotations

import torch

from ..gs.rasterize import ALPHA_MIN, T_MIN, TILE, pixel_centers
from . import _build

NPIX = TILE * TILE
MAX_PAY = 26      # payload channels the kernel takes (rgb + depth + 22 extras)
ALPHA_MAX = 0.999
launches = 0      # calls of the forward wrapper that launched the kernel
bwd_launches = 0  # calls of the backward wrapper that launched the kernel


def _chunk(n_tiles: int) -> int:
    """Pair slots per step of the plain versions: ~2^23 (tile, slot, pixel)
    elements per intermediate."""
    return max(1, (1 << 23) // max(n_tiles * NPIX, 1))


def _slots(feats, bounds, tw, k0, k1, reverse):
    """Pair rows of slots k0..k1 of every tile, with their validity mask,
    row index, alpha before the T gate and its pieces. alpha is computed in
    float32 op by op as the kernel does (so every alpha >= 1/255 decision is
    the kernel's), everything after it in float64."""
    n_tiles = bounds.numel() - 1
    starts, ends = bounds[:-1].long(), bounds[1:].long()
    k = torch.arange(k0, k1, device=feats.device)
    valid = k[None] < (ends - starts)[:, None]                          # (T, c)
    pos = (ends[:, None] - 1 - k[None]) if reverse else (starts[:, None] + k[None])
    pos = pos.clamp(0, max(feats.shape[0] - 1, 0))
    rows = feats[pos] * valid[..., None]                                # (T, c, F) f32
    px, py = pixel_centers(n_tiles, tw, feats.device)
    dx = px[:, None, :] - rows[..., 0:1]                                # (T, c, 256)
    dy = py[:, None, :] - rows[..., 1:2]
    power = -0.5 * (rows[..., 2:3] * dx * dx + rows[..., 4:5] * dy * dy) - rows[..., 3:4] * dx * dy
    g2d = torch.exp(power)
    a0 = rows[..., 5:6] * g2d
    alpha = torch.clamp(a0, max=ALPHA_MAX)
    alpha = torch.where(valid[..., None] & (alpha >= ALPHA_MIN), alpha, torch.zeros_like(alpha))
    return (rows.double(), valid, pos, k, dx.double(), dy.double(), g2d.double(), a0.double(),
            alpha.double())


def _gate(T, alpha):
    """Alpha zeroed where the transmittance before the pair is <= T_MIN,
    and that transmittance, from the chunk's running product (T only
    falls, so the ungated product decides the gate exactly)."""
    excl = torch.cumprod(1.0 - alpha, dim=1)
    excl = torch.cat([torch.ones_like(excl[:, :1]), excl[:, :-1]], 1)
    t_before = T[:, None] * excl
    alpha = torch.where(t_before > T_MIN, alpha, torch.zeros_like(alpha))
    return alpha, t_before


def plain_tile_composite(feats, bounds, tw: int, npay: int, *, reverse: bool = False,
                         stats: dict | None = None):
    """The reference in plain PyTorch, float64 after alpha: (out, last) as
    the kernel. A differentiable loop over chunks of pair slots of all tiles at
    once, masked per tile. `reverse` composites each tile's pairs back to
    front (a planted fault). A `stats` dict receives "contributions", the
    number of (pair, pixel) evaluations that add to a pixel."""
    n_tiles = bounds.numel() - 1
    dev = feats.device
    maxc = int((bounds[1:] - bounds[:-1]).max()) if n_tiles else 0
    T = torch.ones(n_tiles, NPIX, dtype=torch.float64, device=dev)
    acc = torch.zeros(n_tiles, npay, NPIX, dtype=torch.float64, device=dev)
    last = torch.zeros(n_tiles, NPIX, dtype=torch.int32, device=dev)
    contributions = torch.zeros((), dtype=torch.int64, device=dev)
    ck = _chunk(n_tiles)
    for k0 in range(0, maxc, ck):
        rows, _, _, k, _, _, _, _, alpha = _slots(feats, bounds, tw, k0, min(k0 + ck, maxc),
                                                  reverse)
        alpha, t_before = _gate(T, alpha)
        w = alpha * t_before
        acc = acc + torch.einsum("tcp,tcf->tfp", w, rows[..., 6:6 + npay])
        T = T * torch.prod(1.0 - alpha, dim=1)
        hit = (alpha > 0).int() * (k[None, :, None] + 1).int()
        last = torch.maximum(last, hit.amax(1))
        contributions += (alpha > 0).sum()
    if stats is not None:
        stats["contributions"] = int(contributions)
    out = torch.cat([acc, T[:, None]], 1).float()
    return out, last


def plain_tile_composite_bwd(feats, bounds, gout, tw: int, npay: int, *,
                             drop_occlusion: bool = False):
    """The gradient of `plain_tile_composite`'s out for the upstream gout,
    per pair row (P, 6 + npay) f32, float64 after alpha: two forward sweeps as on
    the TPU (totals of w * G and the final T, then prefix sums with suffix =
    total - prefix). `drop_occlusion` leaves out the (suffix + tail) /
    (1 - alpha) occlusion term (a planted fault)."""
    n_tiles = bounds.numel() - 1
    dev = feats.device
    nfeat = 6 + npay
    maxc = int((bounds[1:] - bounds[:-1]).max()) if n_tiles else 0
    gpay = gout[:, :npay].double()                                      # (T, npay, 256)
    gT = gout[:, npay].double()
    ck = _chunk(n_tiles)

    def sweep():
        T = torch.ones(n_tiles, NPIX, dtype=torch.float64, device=dev)
        for k0 in range(0, maxc, ck):
            s = _slots(feats, bounds, tw, k0, min(k0 + ck, maxc), False)
            rows, alpha = s[0], s[-1]
            alpha, t_before = _gate(T, alpha)
            G = torch.einsum("tcf,tfp->tcp", rows[..., 6:6 + npay], gpay)
            yield s, alpha, t_before, G
            T = T * torch.prod(1.0 - alpha, dim=1)
        yield T

    total = torch.zeros(n_tiles, NPIX, dtype=torch.float64, device=dev)
    for item in sweep():
        if isinstance(item, torch.Tensor):
            tail = item * gT
            break
        _, alpha, t_before, G = item
        total = total + (alpha * t_before * G).sum(1)

    dfeats = torch.zeros(feats.shape[0], nfeat, dtype=torch.float32, device=dev)
    cum = torch.zeros(n_tiles, NPIX, dtype=torch.float64, device=dev)
    for item in sweep():
        if isinstance(item, torch.Tensor):
            break
        (rows, valid, pos, _, dx, dy, g2d, a0, _), alpha, t_before, G = item
        w = alpha * t_before
        wG = w * G
        pref = cum[:, None] + torch.cumsum(wG, 1)
        dalpha = t_before * G
        if not drop_occlusion:
            dalpha = dalpha - (total[:, None] - pref + tail[:, None]) / (1.0 - alpha)
        dalpha = torch.where((alpha > 0) & (a0 < ALPHA_MAX), dalpha, torch.zeros_like(dalpha))
        dpow = dalpha * a0
        ca, cb, cc = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5]
        grads = torch.stack([(dpow * (ca * dx + cb * dy)).sum(-1),
                             (dpow * (cc * dy + cb * dx)).sum(-1),
                             (-0.5 * dpow * dx * dx).sum(-1),
                             (-dpow * dx * dy).sum(-1),
                             (-0.5 * dpow * dy * dy).sum(-1),
                             (dalpha * g2d).sum(-1)], -1)
        dpay = torch.einsum("tcp,tfp->tcf", w, gpay)
        g = torch.cat([grads, dpay], -1).float()
        dfeats[pos[valid]] = g[valid]
        cum = cum + wG.sum(1)
    return dfeats


def _check(feats, bounds, npay, tw):
    _build.require(feats, "feats", torch.float32)
    _build.require(bounds, "bounds", torch.int32)
    if feats.ndim != 2 or feats.shape[1] != 6 + npay or not 1 <= npay <= MAX_PAY:
        raise ValueError(f"feats: expected (P, 6 + npay) with 1 <= npay <= {MAX_PAY}, "
                         f"got {tuple(feats.shape)} and npay {npay}")
    if bounds.ndim != 1 or bounds.numel() < 2 or tw < 1:
        raise ValueError(f"bounds: expected (n_tiles + 1,), got {tuple(bounds.shape)}")


def plain_tile_order(work):
    """`tile_order` in plain PyTorch."""
    return torch.argsort(work, descending=True, stable=True).int()


def tile_order(work):
    """The tiles heaviest first, the order in which the kernels' persistent
    blocks take them: indices (int32) of `work` (n_tiles,) i32 by
    decreasing work, ties in tile order. The kernels sort inside their own
    launch; this wrapper runs that sort alone (CUDA) or its plain version
    (CPU)."""
    if work.device.type == "cpu":
        return plain_tile_order(work)
    _build.require(work, "work", torch.int32)
    order = torch.empty(work.numel(), device=work.device, dtype=torch.int32)
    err = _build.load().mudg_tile_order(_build.ptr(work), _build.ptr(order), work.numel(),
                                        _build.stream())
    _build.check(err, "tile_order")
    return order


def tile_composite(feats, bounds, tw: int, npay: int):
    """Composite each tile's pairs: (out (n_tiles, npay + 1, 256) f32,
    last (n_tiles, 256) i32)."""
    global launches
    if feats.device.type == "cpu":
        return plain_tile_composite(feats, bounds, tw, npay)
    _check(feats, bounds, npay, tw)
    n_tiles = bounds.numel() - 1
    out = torch.empty(n_tiles, npay + 1, NPIX, device=feats.device, dtype=torch.float32)
    last = torch.empty(n_tiles, NPIX, device=feats.device, dtype=torch.int32)
    order = torch.empty(n_tiles, device=feats.device, dtype=torch.int32)   # scratch
    P = _build.ptr
    err = _build.load().mudg_tile_composite(P(feats), P(bounds), P(order), P(out), P(last),
                                            n_tiles, tw, npay, feats.shape[0], _build.stream())
    _build.check(err, "tile_composite")
    launches += 1
    return out, last


def tile_composite_bwd(feats, bounds, out, last, gout, tw: int, npay: int):
    """The gradient (P, 6 + npay) f32 of `tile_composite`'s out per pair
    row, from the forward's out and last and the upstream gout."""
    global bwd_launches
    if feats.device.type == "cpu":
        return plain_tile_composite_bwd(feats, bounds, gout, tw, npay)
    _check(feats, bounds, npay, tw)
    n_tiles = bounds.numel() - 1
    for t, name, dtype in ((out, "out", torch.float32), (gout, "gout", torch.float32),
                           (last, "last", torch.int32)):
        _build.require(t, name, dtype)
    if out.shape != (n_tiles, npay + 1, NPIX) or gout.shape != out.shape \
            or last.shape != (n_tiles, NPIX):
        raise ValueError(f"out {tuple(out.shape)}, gout {tuple(gout.shape)}, last "
                         f"{tuple(last.shape)} do not match {n_tiles} tiles, npay {npay}")
    dfeats = torch.empty_like(feats)
    tmax = last.amax(1)
    order = torch.empty(n_tiles, device=feats.device, dtype=torch.int32)   # scratch
    P = _build.ptr
    err = _build.load().mudg_tile_composite_bwd(P(feats), P(bounds), P(order), P(tmax), P(out),
                                                P(last), P(gout), P(dfeats), n_tiles, tw, npay,
                                                feats.shape[0], _build.stream())
    _build.check(err, "tile_composite_bwd")
    bwd_launches += 1
    return dfeats


class _TileComposite(torch.autograd.Function):
    """Kernel 13 forward and backward (the JAX package's `composite_tiles`)."""

    @staticmethod
    def forward(ctx, feats, bounds, tw, npay):
        out, last = tile_composite(feats, bounds, tw, npay)
        ctx.save_for_backward(feats, bounds, out, last)
        ctx.args = (tw, npay)
        return out

    @staticmethod
    def backward(ctx, gout):
        feats, bounds, out, last = ctx.saved_tensors
        dfeats = tile_composite_bwd(feats, bounds, out, last, gout.contiguous(), *ctx.args)
        return dfeats, None, None, None


def composite_tiles(feats, bounds, tw: int, npay: int):
    """(n_tiles, npay + 1, 256) [payload..., T] with a gradient to feats."""
    return _TileComposite.apply(feats, bounds, tw, npay)
