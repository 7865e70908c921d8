"""Megatron tensor parallelism of the UNet's attention and feed-forward
weights over the `model` ranks (port of `mudg_tpu/parallel/tp.py`).

JAX only annotates the weights and lets XLA's partitioner insert the
collectives. Its layout, in JAX's (in, out) weights:

  to_q/to_k/to_v/to_k_ip/to_v_ip  (in, out) -> P(None, 'model')   [column]
  to_out.0                        (in, out) -> P('model', None)   [row]
  ff.net.0.proj                   (in, out) -> P(None, 'model')   [column]
  ff.net.2                        (in, out) -> P('model', None)   [row]
  everything else (biases included) replicated.

In torch's (out, in) weights a column layer is cut along dim 0 and a row
layer along dim 1 (`tp_dim`). Each rank keeps its block of the weight and
runs the layer itself (`linear`, which `nn/functional.linear` hands a
module that `shard_unet_tp` marked): a column layer's input passes an
identity whose backward sums the input's gradient over the group, a row
layer's partial output is summed over the group (identity backward) and its
bias added once, after the sum. A replicated bias of a column layer is
sliced at use, its gradient summed over the group, so that it stays equal
on every rank.

Two things that XLA hides are the port's to handle:
  * whole heads: attention runs on whole heads per rank, so a transformer
    block's attention layers are cut only where its heads divide by the
    ranks (`heads % n == 0`; the block's `heads` becomes heads / n). At
    MDM512, 64-channel heads give 5 heads at C = 320, 10 at 640 and 20 at
    1280: `--tp 2` keeps the C = 320 blocks' attention replicated, `--tp 4`
    those at C = 320 and 640 (`replicated_for_heads` lists them). XLA cuts
    a head in two and reshards; the function is the same either way.
  * GEGLU: net.0.proj holds [u | g] along its outputs, chunked in two after
    the product, so a plain column cut would give rank 0 all of u and rank
    1 all of g. Each half is cut into n blocks instead, and a rank holds
    [u_i | g_i] (`GEGLU`); it is replicated where the inner width does not
    divide by n.

A sharded UNet runs impl="plain": no kernel runs on a shard, as JAX forces
impl="xla" (tp.py:17-21).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as TF

from . import mesh as PM
from ..nn import remat as R

_COLUMN = ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip", "proj")
COLUMN, ROW, GEGLU = "column", "row", "geglu"


def _spec_for_path(names, jshape, n_model: int) -> int | None:
    """The JAX dim (of the JAX-layout shape) that JAX's layout cuts over
    'model', or None (tp.py:_spec_for_path: 1 for P(None, 'model'), 0 for
    P('model', None))."""
    if not names or names[-1] not in ("weight", "weight_i8", "weight_q8") or len(jshape) != 2:
        return None
    parent = names[-2] if len(names) >= 2 else ""
    gparent = names[-3] if len(names) >= 3 else ""
    in_ff = "net" in names
    in_attn = any(n.startswith("attn") for n in names)
    if not (in_ff or in_attn):
        return None
    if parent in _COLUMN or (in_ff and parent == "proj"):
        return 1 if jshape[1] % n_model == 0 else None
    if (in_attn and parent == "0" and gparent == "to_out") or (
            in_ff and parent == "2" and gparent == "net"):
        return 0 if jshape[0] % n_model == 0 else None
    return None


def tp_dim(name: str, shape, n_model: int) -> int | None:
    """The torch dim that JAX's layout cuts for the UNet leaf `name`."""
    j = _spec_for_path(name.split("."), PM.jax_shape(name, shape), n_model)
    return PM.torch_dim(name, len(shape), j)


def unet_tp_shardings(shapes: dict, n_model: int) -> dict:
    """name -> torch dim of JAX's layout for every UNet leaf (name ->
    shape), before the whole-heads rule (tp.py:unet_tp_shardings)."""
    return {k: tp_dim(k, s, n_model) for k, s in shapes.items()}


def unet_tp_fsdp_shardings(shapes: dict, n_model: int, n_data: int,
                           min_size: int = PM.MIN_SIZE) -> dict:
    """name -> (model dim, data dim) (tp.py:unet_tp_fsdp_shardings): JAX's
    TP layout first, then each leaf of at least min_size elements cut over
    'data' on its largest dim that TP leaves free."""
    out = {}
    for k, s in shapes.items():
        d_tp = tp_dim(k, s, n_model)
        d_dp = PM.zero_dim(k, s, n_data, min_size,
                           exclude=() if d_tp is None else (d_tp,))
        out[k] = (d_tp, d_dp)
    return out


def _blocks(unet):
    """(name, BasicTransformerBlock) of every transformer of the UNet."""
    from ..nn.attention import BasicTransformerBlock

    return [(n, m) for n, m in unet.named_modules() if isinstance(m, BasicTransformerBlock)]


def replicated_for_heads(unet, n_model: int) -> list[str]:
    """The transformer blocks whose attention stays whole under n_model
    ranks because their heads do not divide by it."""
    return [n for n, blk in _blocks(unet) if blk.heads % n_model]


def unet_tp_layout(unet, n_model: int) -> dict:
    """name -> (torch dim, mode) of every UNet weight that the port cuts:
    JAX's layout, less the attention of the blocks `replicated_for_heads`
    names and the feed-forwards whose inner width does not divide; mode is
    COLUMN, ROW or GEGLU (net.0.proj, cut by halves)."""
    shapes = {k: tuple(p.shape) for k, p in unet.named_parameters()}
    jax_dims = unet_tp_shardings(shapes, n_model)
    out = {}
    for bname, blk in _blocks(unet):
        attn_ok = blk.heads % n_model == 0
        inner = blk.ff.net["2"].in_features
        ff_ok = inner % n_model == 0
        for k in shapes:
            if not k.startswith(bname + ".") or jax_dims[k] is None:
                continue
            rel = k[len(bname) + 1:]
            if rel.startswith("ff."):
                if not ff_ok:
                    continue
                mode = GEGLU if rel == "ff.net.0.proj.weight" else ROW
            else:
                if not attn_ok:
                    continue
                mode = ROW if ".to_out." in rel else COLUMN
            out[k] = (jax_dims[k], mode)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the input's gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def geglu_rows(total: int, n: int, i: int) -> torch.Tensor:
    """Rows of [u | g] (total = 2 * inner) that rank i holds: [u_i | g_i]."""
    half = total // 2
    lo, hi = PM.block(half, n, i)
    return torch.cat([torch.arange(lo, hi), torch.arange(half + lo, half + hi)])


class _SliceBias(torch.autograd.Function):
    """A replicated bias's rows `idx` (a column layer's block); the
    gradient, zero off the block, summed over the group, so that every rank
    holds the whole bias's gradient."""

    @staticmethod
    def forward(ctx, b, idx, group):
        ctx.idx, ctx.group, ctx.n = idx, group, b.shape[0]
        return b[idx]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.n)
        full[ctx.idx] = g
        dist.all_reduce(full, group=ctx.group)
        return full, None, None


class Sharded:
    """The TP role of one Linear: mode, group, ranks and this rank's index,
    and for a column layer's whole bias the rows this rank uses (made here,
    so that no op of the forward creates them: a remat replay must see the
    forward's ops); `linear` runs it."""

    def __init__(self, mode, group, n, i, bias=None):
        self.mode, self.group = mode, group
        self.bias_rows = None
        if bias is not None and mode != ROW:
            rows = (geglu_rows(bias.shape[0], n, i) if mode == GEGLU
                    else torch.arange(*PM.block(bias.shape[0], n, i)))
            self.bias_rows = rows.to(bias.device)

    def linear(self, m, x, site):
        w = m.weight.to(x.dtype)
        b = None if m.bias is None else m.bias.to(x.dtype)
        if self.mode == ROW:
            with R.site(site):
                y = TF.linear(x, w)
            y = _ReduceFromModel.apply(y, self.group)
            return y if b is None else y + b
        x = _CopyToModel.apply(x, self.group)
        if b is not None:
            b = _SliceBias.apply(b, self.bias_rows, self.group)
        with R.site(site):
            return TF.linear(x, w, b)


def local_block(full: torch.Tensor, dim: int, mode: str, n: int, i: int) -> torch.Tensor:
    """Rank i's block of a full weight under `mode`."""
    if mode == GEGLU:
        return full[geglu_rows(full.shape[0], n, i).to(full.device)]
    return PM.local_slice(full, dim, n, i)


def full_weight(local: torch.Tensor, dim: int, mode: str, group, n: int) -> torch.Tensor:
    """The whole weight from every rank's block (an all-gather)."""
    cat = PM.gather_cat(local.detach().contiguous(), dim, group, n)
    if mode != GEGLU or n == 1:
        return cat
    per = local.shape[0] // 2
    parts = cat.split(per)   # u_0, g_0, u_1, g_1, ...
    return torch.cat(list(parts[0::2]) + list(parts[1::2]))


@torch.no_grad()
def shard_unet_tp(unet, mesh: PM.Mesh, axis: str = "model") -> dict:
    """Cut the UNet's weights in place over the mesh's `axis`
    (tp.py:shard_unet_tp): every weight of `unet_tp_layout` becomes this
    rank's block (a new Parameter), its Linear marked for `linear`, and each
    cut block's `heads` divided by the ranks. Returns the layout, kept as
    `unet.tp_layout` with the group as `unet.tp_group`."""
    n, i, group = mesh.shape[axis], mesh.coord(axis), mesh.group(axis)
    layout = unet_tp_layout(unet, n)
    mods = dict(unet.named_modules())
    for name, (dim, mode) in layout.items():
        lin = mods[name.rsplit(".", 1)[0]]
        lin.weight = torch.nn.Parameter(local_block(lin.weight, dim, mode, n, i).clone(),
                                        requires_grad=lin.weight.requires_grad)
        lin.tp = Sharded(mode, group, n, i, lin.bias)
    for bname, blk in _blocks(unet):
        if f"{bname}.attn1.to_q.weight" in layout:
            blk.heads //= n
    unet.tp_layout = layout
    unet.tp_group = group
    return layout
