"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py),
plus tests of the helpers themselves.

Parity recipe: a JAX parameter tree is given random values with numpy (every
leaf, so the zero-initialised output projections carry signal), fed to the
JAX function, and loaded into the port's module through
`mudg_tpu_torch.convert`; the same numpy inputs go to both sides.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudg_tpu_torch import convert


def random_tree(shapes, seed: int = 0):
    """Numpy values for every leaf of a tree of shapes (jax.eval_shape
    output or arrays), JAX layouts: matrices N(0, 1/fan_in) with fan_in the
    product of all but the last axis, norm scales 1 + 0.1 N(0, 1), biases and
    other leaves 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        shape = tuple(node.shape)
        r = rng.standard_normal(shape)
        if name == "weight" and len(shape) >= 2:
            r /= math.sqrt(math.prod(shape[:-1]))
        elif name == "weight":
            r = 1.0 + 0.1 * r
        else:
            r *= 0.1
        return r.astype(np.float32)

    return walk(shapes, "")


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def port(module: torch.nn.Module, tree):
    """Load a numpy tree into a port module (strict) and return it in eval mode."""
    return convert.load_tree(module, tree).eval()


def assert_close(ours, ref, rel: float, atol: float = 0.0, name: str = ""):
    """max|ours - ref| <= rel * max|ref| + atol, with finite values."""
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().float().cpu().numpy()
    ours = np.asarray(ours, np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    assert np.isfinite(ours).all(), f"{name}: non-finite output"
    diff = float(np.abs(ours - ref).max())
    scale = float(np.abs(ref).max())
    assert diff <= rel * scale + atol, (
        f"{name}: max|diff| {diff:.3e} > {rel:g} * {scale:.3e} + {atol:g}")


def t(a):
    """numpy -> torch (float32 stays float32)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def count_kernel_calls(monkeypatch) -> dict[str, int]:
    """Wrap every kernel wrapper of the port so that each call adds one to
    the returned dict (keyed as `mudg_tpu_torch.kernels.KERNELS`), on any
    device, the meta device included."""
    from mudg_tpu_torch.kernels import flash_attention as FA
    from mudg_tpu_torch.kernels import mlp as M
    from mudg_tpu_torch.kernels import spatial_attn as SP
    from mudg_tpu_torch.kernels import tconv as TC
    from mudg_tpu_torch.kernels import temporal_attn as TA

    calls = {"spatial_attn": 0, "temporal_attn": 0, "geglu_ff": 0, "gn_silu_tconv": 0,
             "flash_attention": 0}

    def count(mod, fn, name):
        orig = getattr(mod, fn)

        def wrapped(*a, **k):
            calls[name] += 1
            return orig(*a, **k)

        monkeypatch.setattr(mod, fn, wrapped)

    count(SP, "fused_self_attention", "spatial_attn")
    count(TA, "fused_double_self_attn", "temporal_attn")
    count(M, "fused_geglu_ff", "geglu_ff")
    count(M, "fused_geglu_ff_block", "geglu_ff")
    count(TC, "fused_gn_silu_tconv", "gn_silu_tconv")
    count(FA, "flash_attention", "flash_attention")
    return calls


def test_random_tree_covers_every_leaf():
    shapes = {"a": {"weight": jax.ShapeDtypeStruct((4, 8), jnp.float32),
                    "bias": jax.ShapeDtypeStruct((8,), jnp.float32)},
              "norm": {"weight": jax.ShapeDtypeStruct((8,), jnp.float32)}}
    tree = random_tree(shapes, seed=3)
    assert tree["a"]["weight"].shape == (4, 8)
    assert np.all(tree["a"]["bias"] != 0)
    assert abs(float(tree["norm"]["weight"].mean()) - 1.0) < 0.2
    again = random_tree(shapes, seed=3)
    np.testing.assert_array_equal(tree["a"]["weight"], again["a"]["weight"])


@pytest.mark.parametrize("rel,ok", [(1e-3, True), (1e-6, False)])
def test_assert_close_tolerance(rel, ok):
    ref = np.array([1.0, -2.0], np.float32)
    ours = ref + np.array([1e-4, 0.0], np.float32)
    if ok:
        assert_close(ours, ref, rel)
    else:
        with pytest.raises(AssertionError):
            assert_close(ours, ref, rel)
