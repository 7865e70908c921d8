"""Sequence parallelism: one clip's UNet sharded over the `seq` ranks
(port of `mudg_tpu/parallel/sp.py`).

The UNet's spatial layers see (B*T, H, W, C), frames independent, and its
temporal layers (B, T, H, W, C), pixels independent. So a rank holds a
block of the B*T frame rows in the spatial layers ("rows") and a block of W
in the temporal ones ("video"), and each layout transition is one
all-to-all (`to_video`, `to_rows`) inside an autograd Function whose
backward is the reverse all-to-all, so that training under `--sp` has its
gradient. Where the shapes do not divide (B*T or W not a multiple of the
ranks), the transition all-gathers and slices instead, the blocks cut as
torch.tensor_split cuts them; JAX's annotation path replicates and slices
there (`_explicit_ok`, sp.py:123-125).

Two norms of the temporal layers reduce over T*H*W, which a W block holds
only part of: the GroupNorms of the temporal conv block and the norm of the
temporal transformer. XLA inserts the cross-device sums for them; here
`stats_sum` hands `nn/functional.group_norm` a differentiable sum over the
`seq` group for its per-channel statistics (two small all-reduces per
norm: the sums with the element count, then the centered sums and squares).

The spatial layers' GroupNorms are per frame and need nothing. The UNet's
output is all-gathered, so every rank of the group holds the whole result.
Under a `data` axis beside `seq` (training), the UNet sees its data group's
own clips and the collectives stay inside the seq group. Kernels run per
shard nowhere: a sharded UNet takes impl="plain", as JAX's takes "xla".
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import mesh as PM


@dataclasses.dataclass(frozen=True)
class SeqSharding:
    """The `seq` axis of a mesh (sp.py:SeqSharding). frames: the frame
    count T of the clip the UNet runs (bound by its forward, `for_clip`),
    which tells a rank the B*T that the rows blocks cut when they are
    uneven. A `data` axis beside `seq` needs
    nothing here: each data group's UNet sees its own clips (JAX's
    data_axis, which shards B inside the UNet)."""
    mesh: PM.Mesh
    axis: str = "seq"
    frames: int | None = None

    @property
    def group(self):
        return self.mesh.group(self.axis)

    @property
    def n(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def index(self) -> int:
        return self.mesh.coord(self.axis)

    def for_clip(self, frames: int) -> "SeqSharding":
        return dataclasses.replace(self, frames=frames)


def make_seq_sharding(mesh: PM.Mesh, axis: str = "seq") -> SeqSharding:
    return SeqSharding(mesh, axis)


def _block(x, dim, sp):
    return PM.local_slice(x, dim, sp.n, sp.index)


def rows(x, sp: SeqSharding | None):
    """This rank's block of the (B*T) rows of x (dim 0)."""
    return x if sp is None else _block(x, 0, sp)


def video(x, sp: SeqSharding | None):
    """This rank's block of W of a (B, T, H, W, C) tensor."""
    return x if sp is None else _block(x, 3, sp)


def frames(x, sp: SeqSharding | None):
    """This rank's block of T of a (B, T, ...) tensor (the frozen VAE's
    per-frame encode and decode)."""
    return x if sp is None else _block(x, 1, sp)


class _Gather(torch.autograd.Function):
    """Every rank's block along dim, concatenated; the gradient of a block
    is its own slice of the (identical) whole's gradient."""

    @staticmethod
    def forward(ctx, x, dim, sp):
        ctx.dim, ctx.sp = dim, sp
        return PM.gather_cat(x, dim, sp.group, sp.n)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.sp).contiguous(), None, None


def gather(x, dim: int, sp: SeqSharding | None):
    """The whole of a tensor whose block along dim each rank holds."""
    return x if sp is None or sp.n == 1 else _Gather.apply(x, dim, sp)


def stats_sum(sp: SeqSharding | None):
    """The differentiable sum over the seq group that a GroupNorm of the
    temporal layers applies to its statistics, or None."""
    if sp is None:
        return None
    group = sp.group
    return lambda x: PM.all_reduce_sum(x, group)


def kw(sp: SeqSharding | None) -> dict:
    """{"sp": sp} for a call that takes it, {} without sharding (so that a
    layer's call without SP is the call it was)."""
    return {} if sp is None else {"sp": sp}


def _explicit_ok(sp: SeqSharding, bt: int, ww: int) -> bool:
    """The all-to-all path where both B*T and W divide, as JAX's
    _explicit_ok; the all-gather fallback otherwise."""
    return ww % sp.n == 0 and bt % sp.n == 0


def _concat_order(n: int) -> list[int]:
    """The order in which the all-to-all's received blocks are laid end to
    end: rank order."""
    return list(range(n))


def _reorder(y, n):
    order = _concat_order(n)
    return y if order == list(range(n)) else y[order]


def _a2a(x, group):
    x = x.contiguous()
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x, group=group)
    return y


def _rows_to_video(h, b, sp):
    """(bt_i, H, W, C) rows block -> (B, T, H, W_i, C) W block."""
    bt_l, hh, ww, c = h.shape
    n = sp.n
    if _explicit_ok(sp, b * sp.frames if sp.frames else bt_l * n, ww):
        send = h.reshape(bt_l, hh, n, ww // n, c).permute(2, 0, 1, 3, 4)
        got = _reorder(_a2a(send, sp.group), n)   # (n, bt/n, H, W/n, C), rows blocks in order
        return got.reshape(b, -1, hh, ww // n, c)
    full = PM.gather_cat(h, 0, sp.group, n)
    return _block(full.reshape(b, -1, hh, ww, c), 3, sp).contiguous()


def _video_to_rows(hv, sp, width):
    """(B, T, H, W_i, C) W block -> (bt_i, H, W, C) rows block."""
    b, t, hh, w_l, c = hv.shape
    n = sp.n
    bt = b * t
    if _explicit_ok(sp, bt, width):
        send = hv.reshape(n, bt // n, hh, w_l, c)
        got = _reorder(_a2a(send, sp.group), n)   # (n, bt/n, H, W/n, C), W blocks in order
        return got.permute(1, 2, 0, 3, 4).reshape(bt // n, hh, w_l * n, c)
    full = PM.gather_cat(hv, 3, sp.group, n)
    return _block(full.reshape(bt, hh, -1, c), 0, sp).contiguous()


class _ToVideo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, b, sp):
        ctx.sp, ctx.width = sp, h.shape[2]
        return _rows_to_video(h, b, sp)

    @staticmethod
    def backward(ctx, g):
        return _video_to_rows(g, ctx.sp, ctx.width), None, None


class _ToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hv, sp, width):
        ctx.sp, ctx.b = sp, hv.shape[0]
        return _video_to_rows(hv, sp, width)

    @staticmethod
    def backward(ctx, g):
        return _rows_to_video(g, ctx.b, ctx.sp), None, None


def to_video(h, batch_size: int, sp: SeqSharding | None):
    """Rows-sharded (B*T, H, W, C) -> W-sharded (B, T, H, W, C)
    (sp.py:to_video): one all-to-all, each rank sending every other the W
    block of its frames that the other keeps."""
    if sp is None:
        bt, hh, ww, c = h.shape
        return h.reshape(batch_size, bt // batch_size, hh, ww, c)
    return _ToVideo.apply(h, batch_size, sp)


def to_rows(hv, sp: SeqSharding | None, width: int | None = None):
    """W-sharded (B, T, H, W, C) -> rows-sharded (B*T, H, W, C), the
    inverse of to_video (sp.py:to_rows). width: the whole W, which a rank's
    block tells only where it divides (default: the block's times n)."""
    if sp is None:
        b, t, hh, ww, c = hv.shape
        return hv.reshape(b * t, hh, ww, c)
    return _ToRows.apply(hv, sp, hv.shape[3] * sp.n if width is None else width)
