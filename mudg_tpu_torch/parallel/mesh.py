"""Process groups, batch sharding and the ZeRO rule (port of
`mudg_tpu/parallel/mesh.py`).

JAX runs every device from one controller and lets the XLA partitioner
insert the collectives. The port runs one process per GPU, launched by
`torchrun` (`python -m torch.distributed.run`), which sets RANK, WORLD_SIZE
and LOCAL_RANK; each process joins one NCCL group (gloo for `--device cpu`)
and calls the collectives itself. A `Mesh` lays the ranks out row-major over
named axes (`data`, `model`, `seq`) and holds one process group per axis
line through this rank; ranks past the mesh's size stay idle, as JAX leaves
devices outside its mesh idle.

`largest_divisible_axis_spec` and `shard_tree_zero` are copies of JAX's,
working on the JAX layout of each leaf (`jax_shape`): they name the dim of
each leaf that a rank keeps a slice of, which `torch_dim` maps back to the
torch layout (a Linear's JAX (in, out) is torch (out, in)), so that both
packages cut every leaf along the same axis.
"""
from __future__ import annotations

import datetime
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

MIN_SIZE = 2 ** 14          # leaves below this stay whole (mesh.py:shard_tree_zero)
TIMEOUT = datetime.timedelta(minutes=10)
BUCKET_ELEMS = 1 << 24      # fp32 elements per gradient all-reduce bucket (64 MiB)


def init_distributed(device: str, timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group torchrun describes; True when more than one
    process runs. A group formed earlier (a test's, chip_smoke's) is used as
    it is. Without torchrun, or at WORLD_SIZE 1, nothing is done and False
    returned: the apps then run as on one device. A CUDA run sets its
    device to LOCAL_RANK first and forms an NCCL group; it raises if the
    group cannot form and never falls back to gloo or to one rank."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo", timeout=timeout,
                            device_id=torch.device("cuda", torch.cuda.current_device())
                            if cuda else None)
    if cuda:
        # local rank 0 builds the kernels while the other ranks wait
        from ..kernels import _build

        _build.build_once_per_host()
    return True


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device: str) -> torch.device:
    """`device` with this process's GPU index under torchrun."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Ranks 0..prod(axis_sizes)-1 laid out row-major over `axis_names`
    (mesh.py:make_mesh). Every rank of the default group must build the
    same meshes in the same order (each axis line is a `new_group`)."""

    def __init__(self, axis_sizes, axis_names):
        sizes = tuple(int(s) for s in axis_sizes)
        self.names = tuple(axis_names)
        self.shape = dict(zip(self.names, sizes))
        n = math.prod(sizes)
        if n > world():
            raise ValueError(f"a mesh of {n} ranks needs {n} processes, {world()} run")
        self.size = n
        me = rank()
        self.active = me < n
        grid = np.arange(n).reshape(sizes)
        self._coords = dict(zip(self.names, np.unravel_index(me, sizes))) if self.active else {}
        self._groups = {}
        for i, name in enumerate(self.names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]).tolist():
                g = dist.new_group(line)
                if me in line:
                    self._groups[name] = g
        self.all = dist.new_group(list(range(n)))

    def coord(self, axis: str) -> int:
        return int(self._coords.get(axis, 0))

    def group(self, axis: str):
        return self._groups.get(axis)

    def device_mesh(self, axis: str, device_type: str):
        """The axis line through this rank as a 1-D DeviceMesh (for FSDP2)."""
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh.from_group(self.group(axis), device_type, mesh_dim_names=(axis,))


def make_mesh(axis_sizes=None, axis_names=("data",)) -> Mesh:
    """A mesh over the running ranks; default one `data` axis over all."""
    if axis_sizes is None:
        axis_sizes = [world()] + [1] * (len(axis_names) - 1)
    return Mesh(axis_sizes, axis_names)


def block(n_rows: int, n: int, i: int) -> tuple[int, int]:
    """Rows [lo, hi) of block i of n (torch.tensor_split's cut: the first
    n_rows % n blocks one row longer)."""
    q, r = divmod(n_rows, n)
    lo = i * q + min(i, r)
    return lo, lo + q + (i < r)


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data", dim: int = 0) -> dict:
    """This rank's rows of every leaf along `dim` (the batch dim; 1 for
    the (accum, B, ...) leaves of an accumulating batch), on its `axis`
    coordinate (mesh.py:shard_batch)."""
    n, i = mesh.shape.get(axis, 1), mesh.coord(axis)
    if n == 1:
        return batch
    return {k: v.narrow(dim, *_span(v.shape[dim], n, i)) for k, v in batch.items()}


def _span(rows, n, i):
    lo, hi = block(rows, n, i)
    return lo, hi - lo


# ---------------------------------------------------------------------------
# The JAX layout of a leaf, and the ZeRO rule on it
# ---------------------------------------------------------------------------

def jax_perm(name: str, ndim: int) -> tuple[int, ...]:
    """perm with torch dim i == JAX dim perm[i] for the leaf `name` (the
    inverse of convert.jax_to_torch_layout): Linear and in_proj weights
    transposed, ConvNd (out, in, k...) from (k..., in, out), embedding
    tables and every non-weight leaf as they are."""
    leaf = name.rsplit(".", 1)[-1]
    ident = tuple(range(ndim))
    if leaf == "in_proj_weight":
        return ident[::-1]
    if leaf != "weight" or name.split(".")[-2:-1] == ["token_embedding"]:
        return ident
    if ndim == 2:
        return (1, 0)
    if ndim >= 3:
        k = ndim - 2
        return (ndim - 1, ndim - 2) + tuple(range(k))
    return ident


def jax_shape(name: str, shape) -> tuple[int, ...]:
    perm = jax_perm(name, len(shape))
    out = [0] * len(shape)
    for i, j in enumerate(perm):
        out[j] = shape[i]
    return tuple(out)


def torch_dim(name: str, ndim: int, jax_dim: int | None) -> int | None:
    return None if jax_dim is None else jax_perm(name, ndim).index(jax_dim)


def largest_divisible_axis_spec(shape, n: int, exclude=()) -> int | None:
    """The largest dim of `shape` divisible by n (the first of equal ones),
    else None (replicated); dims in `exclude` are taken by another axis
    (mesh.py:largest_divisible_axis_spec, which returns the PartitionSpec
    naming that dim)."""
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if i not in exclude and shape[i] % n == 0 and shape[i] >= n:
            return i
    return None


def zero_dim(name: str, shape, n: int, min_size: int = MIN_SIZE, exclude=()) -> int | None:
    """The torch dim of leaf `name` that ZeRO / FSDP over n ranks cuts
    (mesh.py:shard_tree_zero): None below min_size elements or where no dim
    divides; `exclude` holds torch dims taken by tensor parallelism."""
    shape = tuple(shape)
    if math.prod(shape) < min_size:
        return None
    perm = jax_perm(name, len(shape))
    j = largest_divisible_axis_spec(jax_shape(name, shape), n,
                                    exclude={perm[i] for i in exclude})
    return torch_dim(name, len(shape), j)


def shard_tree_zero(shapes: dict, n: int, min_size: int = MIN_SIZE) -> dict:
    """name -> the torch dim ZeRO cuts (or None) for every leaf of `shapes`
    (name -> shape)."""
    return {k: zero_dim(k, s, n, min_size) for k, s in shapes.items()}


def local_tensor(t):
    """The tensor a rank holds of t: a DTensor's (an FSDP2 parameter's or
    gradient's) local shard, else t."""
    return t.to_local() if hasattr(t, "to_local") else t


def local_slice(x: torch.Tensor, dim: int | None, n: int, i: int) -> torch.Tensor:
    """Block i of n of x along dim (a view), x itself for dim None."""
    return x if dim is None or n == 1 else x.narrow(dim, *_span(x.shape[dim], n, i))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def print0(*args, **kw):
    """print on rank 0 only."""
    if rank() == 0:
        print(*args, **kw)


def broadcast_object(obj, src: int = 0, group=None):
    """rank src's `obj` on every rank of `group` (the default group)."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def gather_cat(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Concatenate every rank's x along dim, in rank order; the blocks may
    differ in length along dim (tensor_split's cut), so they are padded to
    the longest for the all-gather and trimmed."""
    if n == 1:
        return x
    lens = [torch.zeros((), dtype=torch.int64, device=x.device) for _ in range(n)]
    dist.all_gather(lens, torch.tensor(x.shape[dim], device=x.device), group=group)
    lens = [int(v) for v in lens]
    top = max(lens)
    xp = x.contiguous()
    if x.shape[dim] < top:
        pad = list(x.shape)
        pad[dim] = top - x.shape[dim]
        xp = torch.cat([xp, xp.new_zeros(pad)], dim)
    parts = [torch.empty_like(xp) for _ in range(n)]
    dist.all_gather(parts, xp, group=group)
    return torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, lens)], dim)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient of each rank's input is the sum of
    every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable sum of x over `group` (plain all_reduce carries no
    gradient)."""
    return _AllReduceSum.apply(x, group)


class Buckets:
    """Flat fp32 all-reduces of many tensors: the tensors are packed in
    order into buckets of at most BUCKET_ELEMS elements (a tensor larger
    than that is a bucket of its own), each bucket summed over `group` in
    one collective, divided by `divide` and unpacked in place. `seconds`
    keeps each call's wall time of the collectives (device synchronised
    around them when `timed`)."""

    def __init__(self, bucket_elems: int = BUCKET_ELEMS, timed: bool = False):
        self.bucket_elems = bucket_elems
        self.timed = timed
        self.seconds: list[float] = []
        self.last_buckets = 0

    def plan(self, tensors):
        out, cur, size = [], [], 0
        for t in tensors:
            if cur and size + t.numel() > self.bucket_elems:
                out.append(cur)
                cur, size = [], 0
            cur.append(t)
            size += t.numel()
        if cur:
            out.append(cur)
        return out

    @torch.no_grad()
    def all_reduce(self, tensors, group, divide: float = 1.0):
        tensors = list(tensors)
        if not tensors:
            return
        sync = self.timed and tensors[0].is_cuda
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        buckets = self.plan(tensors)
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1).float() for t in bucket])
            dist.all_reduce(flat, group=group)
            if divide != 1.0:
                flat /= divide
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
        if sync:
            torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.last_buckets = len(buckets)
