"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py),
plus tests of the helpers themselves.

Parity recipe: a JAX parameter tree is given random values with numpy (every
leaf, so the zero-initialised output projections carry signal), fed to the
JAX function, and loaded into the port's module through
`mudg_tpu_torch.convert`; the same numpy inputs go to both sides.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudg_tpu_torch import convert

# The suite runs under pytest-xdist with about one worker per core. torch's
# default of one intra-op thread per core would have each worker's small CPU
# ops spread over every core and slow the other workers' JAX compiles; the
# parity tests' tensors are small enough for one thread.
torch.set_num_threads(1)


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
    """Load a numpy tree into a port module (strict) on the CPU and return it
    in eval mode."""
    return convert.load_tree(module, tree, device="cpu").eval()


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


# ---------------------------------------------------------------------------
# MDM training parity (tests/test_torch_train*.py)
# ---------------------------------------------------------------------------

TRAIN_FIELDS = ("uncond_prob", "train_encode_chunk", "noise_strength", "interp_mode",
                "l_simple_weight", "original_elbo_weight")
B, T, H, W = 1, 4, 16, 16       # the tiny training batch: 4 frames of 16x16


def no_dropout(cfg):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dropout=0.0))


def tiny_training_setup():
    """The tiny MDM with dropout off, as (JAX config, random numpy tree, a
    seeded numpy batch in the pixel, moments and accumulated-moments forms,
    null token ids)."""
    from mudg_tpu.models import mdm as JMDM
    from mudg_tpu.models import presets as JP

    cfg = no_dropout(JP.tiny())
    tree = random_tree(jax.eval_shape(lambda: JMDM.init_mdm(jax.random.PRNGKey(0), cfg)), 80)
    rng = np.random.default_rng(81)

    def video(*lead):
        return rng.uniform(-1, 1, (*lead, B, T, H, W, 3)).astype(np.float32)

    def moments(*lead):
        return (rng.standard_normal((*lead, B, T, H // 2, W // 2, 8)) * 0.5).astype(np.float32)

    def ints(hi, *shape):
        return rng.integers(0, hi, shape).astype(np.int32)

    vocab = cfg.clip_text.vocab_size
    data = {
        "pixels": dict(dense_frames=video(), sparse_frames=video(), sparse_depth=video(),
                       tokens=ints(vocab, B, 77), class_label=np.array([500], np.int32),
                       fps=np.array([7], np.int32)),
        "moments": dict(dense_moments=moments(), sparse_moments=moments(),
                        depth_moments=moments(), sparse_frame0=video()[:, 0],
                        tokens=ints(vocab, B, 77), class_label=np.array([1], np.int32)),
        "accum": dict(dense_moments=moments(2), sparse_moments=moments(2),
                      depth_moments=moments(2), sparse_frame0=video(2)[:, :, 0],
                      tokens=ints(vocab, 2, B, 77), class_label=np.zeros((2, B), np.int32)),
    }
    null_tokens = ints(vocab, 77)
    return cfg, tree, data, null_tokens


def port_training_cfg(cfg):
    """The port's tiny MDMConfig, dropout off, with a JAX config's training
    fields."""
    from mudg_tpu_torch.models import presets as TP

    return dataclasses.replace(no_dropout(TP.tiny()), **{f: getattr(cfg, f) for f in TRAIN_FIELDS})


def torch_batch(batch):
    return {k: t(a).long() if a.dtype.kind == "i" else t(a) for k, a in batch.items()}


def jax_draws(cfg, rng, batch) -> dict:
    """The random draws JAX `training_loss` makes from `rng`, in the form
    `draw_training_noise` returns them (mudg_tpu/models/mdm.py:192-285). The
    pixel-form encode samples each chunk of its scan with one key, so the
    posterior eps repeats every `chunk` frames."""
    keys = jax.random.split(rng, 7)
    if "dense_moments" in batch:
        b, tt, h, w = batch["dense_moments"].shape[:4]
    else:
        b, tt = batch["dense_frames"].shape[:2]
        h, w = H // 2, W // 2
    zc = cfg.vae.embed_dim
    lat = (b, tt, h, w, zc)
    if cfg.interp_mode or "dense_moments" not in batch:
        n = b * tt if cfg.interp_mode else 3 * b * tt
        chunk = cfg.vae_chunk if cfg.interp_mode else cfg.train_encode_chunk
        while not cfg.interp_mode and chunk > 1 and n % chunk:
            chunk //= 2
        if chunk <= 0 or n <= chunk:
            eps = jax.random.normal(keys[0], (n, h, w, zc))
        else:
            eps = jnp.tile(jax.random.normal(keys[0], (chunk, h, w, zc)), (n // chunk, 1, 1, 1))
        post = eps.reshape((n // tt, tt, h, w, zc))
    else:
        post = jax.random.normal(keys[0], (3 * b, tt, h, w, zc))
    draws = {"t": jax.random.randint(keys[3], (b,), 0, cfg.timesteps),
             "noise": jax.random.normal(keys[4], lat),
             "posterior_eps": post,
             "cfg_uniform": jax.random.uniform(keys[2], (b,)),
             "offset_noise": jax.random.normal(keys[6], (b, tt, 1, 1, zc))}
    return {k: t(np.asarray(v)).long() if k == "t" else t(np.asarray(v))
            for k, v in draws.items()}


# ---------------------------------------------------------------------------
# The JAX package's native library and the ETL's outputs
# ---------------------------------------------------------------------------

def jax_native(tmp_dir):
    """The JAX package's `utils/native` with its C++ library built afresh
    into `tmp_dir` (native/build.sh's flags) and loaded, so that a test
    reads no library another process may be writing. Returns the module;
    its _LIB is the library (never the numpy fallback)."""
    import os
    import subprocess

    from mudg_tpu.utils import native as N

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = os.path.join(str(tmp_dir), "libmudg_native.so")
    subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
                    "-std=c++17", os.path.join(repo, "native", "mudg_native.cpp"), "-o", lib],
                   check=True, capture_output=True)
    saved = N._lib_path
    N._LIB, N._TRIED = None, False
    N._lib_path = lambda: lib
    try:
        assert N.load_library(build=False) is not None
    finally:
        N._lib_path = saved
    return N


def tree_equal(ours, ref, path="", rel=0.0):
    """Two trees of dicts, lists, dataclasses, numpy arrays and scalars
    equal: the same keys, shapes and dtypes, floats within `rel` of each
    array's max (0: bit for bit)."""
    if dataclasses.is_dataclass(ref):
        assert type(ours).__name__ == type(ref).__name__, path
        for f in dataclasses.fields(ref):
            tree_equal(getattr(ours, f.name), getattr(ref, f.name), f"{path}.{f.name}", rel)
    elif isinstance(ref, dict):
        assert set(ours) == set(ref), (path, set(ours) ^ set(ref))
        for k in ref:
            tree_equal(ours[k], ref[k], f"{path}/{k}", rel)
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            tree_equal(a, b, f"{path}[{i}]", rel)
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert ours.shape == ref.shape and ours.dtype == ref.dtype, (path, ours.shape,
                                                                     ref.shape, ours.dtype)
        if ref.dtype.kind == "f" and rel:
            scale = max(float(np.abs(ref).max(initial=0)), 1e-300)
            assert float(np.abs(ours - ref).max(initial=0)) <= rel * scale, path
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=path)
    elif isinstance(ref, float):
        assert abs(ours - ref) <= rel * abs(ref), (path, ours, ref)
    else:
        assert ours == ref, (path, ours, ref)


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
