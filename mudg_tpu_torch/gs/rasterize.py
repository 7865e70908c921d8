"""Differentiable capped sort+scan Gaussian rasterizer in plain torch.

Port of `mudg_tpu/gs/rasterize.py` (the `backend="xla"` choice of
`GSConfig`): every gaussian is duplicated over at most `tiles_per_gaussian`
tiles of its opacity-aware box, the (tile, depth) pairs are sorted, each
tile keeps at most `max_per_tile` of them, and a loop over those slots
composites all pixels of all tiles front to back. It is the f32 reference
the tile rasterizer (`gs/tile_raster.py`) is held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .gaussians import (Gaussians, QMAX_CULL_EPS, project_gaussians, rect_qmin,
                        view_colors)

TILE = 16
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4  # stop compositing below this transmittance (3DGS convention)


class RasterOut(NamedTuple):
    color: torch.Tensor     # (H, W, 3)
    depth: torch.Tensor     # (H, W) alpha-weighted expected depth
    alpha: torch.Tensor     # (H, W) accumulated opacity
    n_dropped: int          # gaussian-tile pairs beyond capacity
    features: torch.Tensor | None = None  # (H, W, C) composited extras


def _tile_grid(width, height):
    tw = (width + TILE - 1) // TILE
    th = (height + TILE - 1) // TILE
    return tw, th


def sort_key(tile_id, depth):
    """One int64 key per pair in (tile, depth) order: the tile id in the
    high 32 bits, the float bits of the positive camera depth in the low 32
    (positive floats order as their bit patterns)."""
    bits = depth.detach().float().view(torch.int32).long() & 0xFFFFFFFF
    return (tile_id.long() << 32) | bits


def untile(x, tw: int, th: int, width: int, height: int):
    """(n_tiles, TILE*TILE[, C]) -> (height, width[, C])."""
    flat = x.ndim == 2
    if flat:
        x = x[..., None]
    ch = x.shape[-1]
    x = x.reshape(th, tw, TILE, TILE, ch).permute(0, 2, 1, 3, 4).reshape(th * TILE, tw * TILE, ch)
    x = x[:height, :width]
    return x[..., 0] if flat else x


def pixel_centers(n_tiles: int, tw: int, device):
    """(n_tiles, TILE*TILE) x and y pixel centers, tile-major, row-major in a tile."""
    t = torch.arange(n_tiles, device=device)
    lane = torch.arange(TILE * TILE, device=device)
    px = (t % tw)[:, None] * TILE + (lane % TILE)[None]
    py = (t // tw)[:, None] * TILE + (lane // TILE)[None]
    return px.float() + 0.5, py.float() + 0.5


def rasterize(g: Gaussians, K, w2c, *, width: int, height: int, max_per_tile: int = 256,
              tiles_per_gaussian: int = 16, bg_color=(0.0, 0.0, 0.0), features=None):
    """features: optional (N, C) per-gaussian vectors composited with the
    color (same weights), returned as RasterOut.features (H, W, C)."""
    dev = g.means.device
    proj = project_gaussians(g, K, w2c, width=width, height=height)
    tw, th = _tile_grid(width, height)
    n_tiles = tw * th
    tpg = tiles_per_gaussian

    m2, ext = proj.means2d, proj.extents
    x0 = torch.floor((m2[:, 0] - ext[:, 0]) / TILE).long().clamp(0, tw - 1)
    x1 = torch.floor((m2[:, 0] + ext[:, 0]) / TILE).long().clamp(0, tw - 1)
    y0 = torch.floor((m2[:, 1] - ext[:, 1]) / TILE).long().clamp(0, th - 1)
    y1 = torch.floor((m2[:, 1] + ext[:, 1]) / TILE).long().clamp(0, th - 1)
    span_x = x1 - x0 + 1
    span_y = y1 - y0 + 1

    slot = torch.arange(tpg, device=dev)
    sx = slot[None] % span_x.clamp(min=1)[:, None]
    sy = slot[None] // span_x.clamp(min=1)[:, None]
    tile_x = x0[:, None] + sx
    tile_y = y0[:, None] + sy
    pair_valid = (proj.visible[:, None] & (slot[None] < (span_x * span_y)[:, None])
                  & (tile_y <= y1[:, None]))
    with torch.no_grad():   # exact ellipse-tile cull (an integer decision)
        tx, ty = tile_x.float() * TILE, tile_y.float() * TILE
        qmin = rect_qmin(m2[:, 0:1], m2[:, 1:2], proj.conics[:, 0:1], proj.conics[:, 1:2],
                         proj.conics[:, 2:3], tx + 0.5, tx + (TILE - 0.5), ty + 0.5,
                         ty + (TILE - 0.5))
        pair_valid &= qmin <= proj.qmax[:, None] + QMAX_CULL_EPS
    n_dropped = int((torch.clamp(span_x * span_y - tpg, min=0) * proj.visible).sum())
    tile_id = torch.where(pair_valid, tile_y * tw + tile_x, n_tiles)

    # one stable (tile, depth) sort; pairs of the overflow bin sort last
    depth = torch.where(pair_valid, proj.depths[:, None], torch.zeros_like(proj.depths[:, None]))
    key = sort_key(tile_id.reshape(-1), depth.reshape(-1))
    order = torch.sort(key, stable=True).indices
    sorted_tile = tile_id.reshape(-1)[order]
    sorted_idx = order // tpg

    ids = torch.arange(n_tiles, device=dev)
    starts = torch.searchsorted(sorted_tile, ids)
    counts = torch.searchsorted(sorted_tile, ids, right=True) - starts
    cap = torch.arange(max_per_tile, device=dev)
    gather_pos = (starts[:, None] + cap[None]).clamp(0, sorted_idx.shape[0] - 1)
    table = sorted_idx[gather_pos]                     # (n_tiles, K)
    table_valid = cap[None] < counts[:, None]

    px, py = pixel_centers(n_tiles, tw, dev)
    colors = view_colors(g, w2c)
    if features is not None:
        colors = torch.cat([colors, features], -1)
    n_chan = colors.shape[-1]
    color = torch.zeros(n_tiles, TILE * TILE, n_chan, device=dev)
    dacc = torch.zeros(n_tiles, TILE * TILE, device=dev)
    trans = torch.ones(n_tiles, TILE * TILE, device=dev)
    for k in range(max_per_tile):
        gi = table[:, k]
        dx = px - m2[gi, 0:1]
        dy = py - m2[gi, 1:2]
        con = proj.conics[gi]
        power = -0.5 * (con[:, 0:1] * dx ** 2 + con[:, 2:3] * dy ** 2) - con[:, 1:2] * dx * dy
        alpha = torch.clamp(proj.opacities[gi][:, None] * torch.exp(power), max=0.999)
        keep = table_valid[:, k:k + 1] & (alpha >= ALPHA_MIN) & (trans > T_MIN)
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        w = alpha * trans
        color = color + w[..., None] * colors[gi][:, None, :]
        dacc = dacc + w * proj.depths[gi][:, None]
        trans = trans * (1.0 - alpha)

    feat = color[..., 3:] if features is not None else None
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    color = color[..., :3] + trans[..., None] * bg
    un = lambda x: untile(x, tw, th, width, height)   # noqa: E731
    return RasterOut(color=un(color), depth=un(dacc), alpha=un(1.0 - trans),
                     n_dropped=n_dropped, features=None if feat is None else un(feat))
