"""Tile rasterizer for 3D Gaussian Splatting: exact pair building in torch
ops and compositing by kernel 13 (`kernels/tile_raster.py`).

Port of `mudg_tpu/gs/tile_raster.py`'s public path (`rasterize_pallas`):

  * gaussian -> tile pairs are enumerated exactly, two levels deep:
    gaussian -> the tile rows of its alpha-cutoff ellipse -> the tiles each
    row's closed-form x-interval touches (FlashGS-style);
  * with `max_pairs=None` the pair buffer is sized exactly, every call (a
    count, then an allocation), so nothing is dropped; an explicit
    `max_pairs` keeps the JAX truncation and `n_dropped` semantics;
  * one stable sort of an int64 key, tile id in the high 32 bits and the
    depth's float bits in the low 32: the lossless (tile, depth) order
    (the JAX package's `MUDG_GS_SORT=lex`);
  * pairs live in a row-major (P, 6 + npay) f32 table whose gradient goes
    back to the gaussians by a segment sum over pairs ordered by gaussian
    id (deterministic; no atomics).
"""
from __future__ import annotations

import torch

from ..kernels.tile_raster import composite_tiles
from .gaussians import (Gaussians, QMAX_CULL_EPS, ellipse_row_xrange, project_gaussians,
                        view_colors)
from .rasterize import TILE, RasterOut, _tile_grid, sort_key, untile


def _enumerate_rows(proj, *, tw: int, th: int, max_rows: int | None = None):
    """Gaussian -> ellipse tile rows -> each row's exact tile x-span.
    Returns (rg, ty, tx0, span_x, total_rows): the rows' gaussian, tile row,
    first tile column and tile count, and the untruncated row count. With
    `max_rows`, only the first max_rows rows (in gaussian order) are kept.
    The enumeration is integer decisions only: no gradient."""
    with torch.no_grad():
        m2, ext = proj.means2d, proj.extents
        y0 = torch.floor((m2[:, 1] - ext[:, 1]) / TILE).clamp(0, th - 1).long()
        y1 = torch.floor((m2[:, 1] + ext[:, 1]) / TILE).clamp(0, th - 1).long()
        row_span = torch.where(proj.visible, y1 - y0 + 1, torch.zeros_like(y0))
        total_rows = int(row_span.sum())
        n_rows = total_rows if max_rows is None else min(total_rows, max_rows)
        gids = torch.arange(row_span.shape[0], device=m2.device)
        rg = torch.repeat_interleave(gids, row_span, output_size=total_rows)[:n_rows]
        starts = torch.cumsum(row_span, 0) - row_span
        ty = y0[rg] + (torch.arange(n_rows, device=m2.device) - starts[rg])

        mux, muy = m2[rg, 0], m2[rg, 1]
        ca, cb, cc = proj.conics[rg].unbind(-1)
        ry = ty.float() * TILE
        lo, hi, nonempty = ellipse_row_xrange(ca, cb, cc, proj.qmax[rg] + QMAX_CULL_EPS,
                                              ry + 0.5 - muy, ry + (TILE - 0.5) - muy)
        # tiles whose pixel-centre columns overlap [mux + lo, mux + hi];
        # emptiness is decided before clipping to the image
        tx0 = torch.ceil((mux + lo - (TILE - 0.5)) / TILE).long().clamp(min=0)
        tx1 = torch.floor((mux + hi - 0.5) / TILE).long().clamp(max=tw - 1)
        span_x = torch.where(nonempty & (tx1 >= tx0), tx1 - tx0 + 1, torch.zeros_like(tx0))
    return rg, ty, tx0, span_x, total_rows


def count_pairs(proj, *, width: int, height: int, max_rows: int | None = None):
    """The exact (total_rows, total_pairs) of the enumeration, as ints. With
    a `max_rows` below the row count the pair count is that of the kept rows."""
    tw, th = _tile_grid(width, height)
    _, _, _, span_x, total_rows = _enumerate_rows(proj, tw=tw, th=th, max_rows=max_rows)
    return total_rows, int(span_x.sum())


class _GatherRows(torch.autograd.Function):
    """table[idx] whose backward sums each row's pair gradients by a segment
    sum over the pairs ordered by row id: a fixed order, unlike the atomics
    of index_add_ on CUDA."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        order = torch.sort(idx, stable=True).indices
        lengths = torch.bincount(idx, minlength=ctx.n)
        return torch.segment_reduce(grad[order], "sum", lengths=lengths, axis=0), None


def build_pairs(proj, colors, *, width: int, height: int, max_pairs: int | None = None,
                max_rows: int | None = None, extras=None):
    """Returns (feats (P, 6 + npay) f32, bounds (n_tiles + 1,) i32,
    n_dropped). Pair rows are [mux, muy, conic a, b,
    c, opacity, r, g, b, depth, extras...] in (tile, depth) order; extras:
    optional (N, E) payload channels composited with the color (E <= 22).
    With `max_pairs` (and `max_rows`, default max(max_pairs // 2, 1024)) the
    first pairs in enumeration order are kept and the rest counted in
    n_dropped, as the JAX package does; with neither, P is exact."""
    tw, th = _tile_grid(width, height)
    n_tiles = tw * th
    if max_pairs is not None and max_rows is None:
        max_rows = max(max_pairs // 2, 1024)
    rg, ty, tx0, span_x, total_rows = _enumerate_rows(proj, tw=tw, th=th, max_rows=max_rows)
    dev = rg.device
    with torch.no_grad():
        total = int(span_x.sum())
        n_pairs = total if max_pairs is None else min(total, max_pairs)
        rr = torch.repeat_interleave(torch.arange(rg.shape[0], device=dev), span_x,
                                     output_size=total)[:n_pairs]
        starts = torch.cumsum(span_x, 0) - span_x
        gi = rg[rr]
        tile_id = ty[rr] * tw + tx0[rr] + (torch.arange(n_pairs, device=dev) - starts[rr])
        n_dropped = 0
        if max_pairs is not None:
            n_dropped = max(total - max_pairs, 0) + max(total_rows - max_rows, 0)
        order = torch.sort(sort_key(tile_id, proj.depths[gi]), stable=True).indices
        gid = gi[order]
        bounds = torch.searchsorted(tile_id[order],
                                    torch.arange(n_tiles + 1, device=dev)).int()
    cols = [proj.means2d, proj.conics, proj.opacities[:, None], colors, proj.depths[:, None]]
    if extras is not None:
        cols.append(extras)
    table = torch.cat(cols, 1).float()
    return _GatherRows.apply(table, gid), bounds, n_dropped


def rasterize_tiles(g: Gaussians, K, w2c, *, width: int, height: int,
                    max_pairs: int | None = None, max_rows: int | None = None,
                    bg_color=(0.0, 0.0, 0.0), features=None) -> RasterOut:
    """Differentiable tile rasterization (the counterpart of
    `rasterize_pallas`), without per-tile or per-gaussian caps. features:
    optional (N, E) per-gaussian vectors composited with the color (E <=
    22), returned as RasterOut.features (H, W, E). Compositing is kernel 13
    on a CUDA tensor, its plain version on a CPU tensor."""
    tw, th = _tile_grid(width, height)
    proj = project_gaussians(g, K, w2c, width=width, height=height)
    feats, bounds, n_dropped = build_pairs(proj, view_colors(g, w2c), width=width,
                                              height=height, max_pairs=max_pairs,
                                              max_rows=max_rows, extras=features)
    n_extra = 0 if features is None else features.shape[-1]
    npay = 4 + n_extra
    out = composite_tiles(feats.contiguous(), bounds, tw, npay)
    return raster_out(out, n_extra, tw, th, width, height, bg_color, n_dropped)


def raster_out(out, n_extra: int, tw: int, th: int, width: int, height: int, bg_color,
               n_dropped: int) -> RasterOut:
    """The composited (n_tiles, npay + 1, 256) tiles as a RasterOut image."""
    npay = 4 + n_extra
    trans = out[:, npay]
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=out.device)
    color = out[:, 0:3].transpose(1, 2) + trans[..., None] * bg
    feat = out[:, 4:npay].transpose(1, 2) if n_extra else None
    un = lambda x: untile(x, tw, th, width, height)   # noqa: E731
    return RasterOut(color=un(color), depth=un(out[:, 3]), alpha=un(1.0 - trans),
                     n_dropped=n_dropped, features=None if feat is None else un(feat))
