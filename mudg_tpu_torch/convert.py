"""Carry weights across: JAX parameter trees -> the port's modules.

The JAX package keeps parameters as nested dicts whose paths are the
reference's torch state_dict keys, in channels-last layouts. This module
flattens such a tree and puts every leaf back into its torch layout (a copy
of `mudg_tpu/train/checkpoint.py:pytree_to_state_dict` and
`jax_to_torch_layout`, in numpy: the port imports nothing of the JAX
package). The port's modules have exactly those keys, so the result loads
with `strict=True`. After the load every kernel site packs its weights once
(`prepare_kernels`). A tree that JAX's `quant.quantize_pytree` made int8
loads into a module that `quant.quantize_module` restructured with the same
selection: its `weight_i8`/`weight_q8` leaves take `weight`'s layout rule
and stay int8, `scale` stays as it is.
"""
from __future__ import annotations

import itertools
from typing import Mapping

import numpy as np
import torch

from .kernels import prepare_kernels

# Modules whose '.weight' is an embedding table (kept (vocab, dim), not
# transposed like a Linear); checkpoint.py:30-32.
_EMBEDDING_MODULES = ("token_embedding",)
# the leaves laid out as a Linear or Conv weight: the float one and JAX's
# int8 ones (quant.py)
_WEIGHT_LEAVES = ("weight", "weight_i8", "weight_q8")


def jax_to_torch_layout(key: str, value: np.ndarray) -> np.ndarray:
    """One leaf from the JAX layout back to the torch layout, by rank:
    Linear (in, out) -> (out, in); Conv1d (k, in, out), Conv2d
    (kh, kw, in, out) and Conv3d (kt, kh, kw, in, out) -> (out, in, k...);
    the fused attention in_proj (W, 3W) -> (3W, W); everything else as is."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "in_proj_weight":
        return value.T
    if leaf not in _WEIGHT_LEAVES:
        return value
    if any(key == s + ".weight" or key.endswith("." + s + ".weight")
           for s in _EMBEDDING_MODULES):
        return value
    if value.ndim == 2:
        return value.T
    if value.ndim == 3:
        return value.transpose(2, 1, 0)
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 5:
        return value.transpose(4, 3, 0, 1, 2)
    return value


def pytree_to_state_dict(tree, *, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a parameter tree into {dotted path: torch-layout array}."""
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [k])
        else:
            key = ".".join(path)
            out[prefix + key] = jax_to_torch_layout(key, np.asarray(node))

    walk(tree, [])
    return out


def tree_to_state_dict(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """A JAX parameter tree (leaves: numpy or JAX arrays, any float dtype)
    -> a torch-layout state dict of float32 tensors (int8 leaves stay
    int8)."""
    out = {}
    for k, a in pytree_to_state_dict(tree, prefix=prefix).items():
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def load_tree(module: torch.nn.Module, tree, *, device=None, dtype=None):
    """Load a JAX tree into `module` (strict), optionally moving it to
    `device` and casting it to `dtype`; then pack the kernel weights.
    Returns module. A module built on the meta device is materialised on
    `device`, by default the card ("cuda"), which raises where there is none:
    the CPU is used only when the caller asks for it."""
    sd = tree_to_state_dict(tree)
    if any(p.is_meta for p in itertools.chain(module.parameters(), module.buffers())):
        module.to_empty(device=device or "cuda")
    elif device is not None:
        module.to(device)
    if dtype is not None:
        module.to(dtype)
    module.load_state_dict(sd, strict=True)
    prepare_kernels(module)
    return module


def gaussians_from_arrays(fields: Mapping, device="cuda"):
    """The JAX package's Gaussians fields as numpy arrays (the dict its
    refine-gs app pickles: means, log_scales, quats, opacity, colors,
    active, and sh, sem, group where present) -> the port's Gaussians on
    `device`: floats float32, active bool, group int32."""
    from .gs.gaussians import Gaussians

    def t(k):
        if fields.get(k) is None:
            return None
        a = np.asarray(fields[k])
        a = a.astype(bool if k == "active" else np.int32 if k == "group" else np.float32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Gaussians(**{k: t(k) for k in Gaussians._fields})
