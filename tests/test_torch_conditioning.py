"""PyTorch port vs JAX for the conditioning encoders of `sample`: the OpenCLIP
text and vision towers, the bicubic resize of their preprocessing, the
Perceiver resampler and the stacked VAE encode of the sparse conditions, at
the `tiny` preset's configs.

Every leaf of every parameter tree is randomized (test_torch_util.random_tree).
Tolerance of the fp32 comparisons: tests/test_reference_oracle.py:50,
2e-3 * scale + 5e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudg_tpu.conditioning import clip as JCL
from mudg_tpu.models import mdm as JMDM
from mudg_tpu.models import presets as JP
from mudg_tpu.nn import resampler as JR
from mudg_tpu_torch.conditioning import clip as TCL
from mudg_tpu_torch.models import mdm as TMDM
from mudg_tpu_torch.models import presets as TP
from mudg_tpu_torch.nn import resampler as TR
from test_torch_util import assert_close, port, random_tree, t, to_jax

TOL, ATOL = 2e-3, 5e-5


@pytest.fixture(scope="module")
def cfg():
    return JP.tiny()


def _tree(init, seed):
    return random_tree(jax.eval_shape(init), seed)


def test_text_tower_matches_jax(cfg):
    key = jax.random.PRNGKey(0)
    tree = _tree(lambda: JCL.init_text_tower(key, cfg.clip_text), 11)
    tokens = np.random.default_rng(5).integers(0, cfg.clip_text.vocab_size, (2, 77))
    ref = JCL.text_tower_apply(to_jax(tree), cfg.clip_text, jnp.asarray(tokens, jnp.int32))
    tower = port(TCL.TextTower(TP.tiny().clip_text), tree)
    with torch.no_grad():
        ours = tower(t(tokens))
    assert_close(ours, ref, TOL, ATOL, "text tower")


def test_text_tower_is_causal(cfg):
    """Changing the last token leaves every earlier position unchanged."""
    tree = _tree(lambda: JCL.init_text_tower(jax.random.PRNGKey(0), cfg.clip_text), 12)
    tower = port(TCL.TextTower(TP.tiny().clip_text), tree)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 1000, (1, 77)))
    other = tokens.clone()
    other[0, -1] += 1
    with torch.no_grad():
        a, b = tower(tokens), tower(other)
    torch.testing.assert_close(a[:, :-1], b[:, :-1], rtol=0, atol=0)
    assert (a[:, -1] - b[:, -1]).abs().max() > 0


@pytest.mark.parametrize("shape", [(2, 40, 72, 3), (1, 300, 460, 3), (1, 224, 500, 3)])
def test_resize_matches_jax_bicubic(shape):
    """Up- and down-sampling (antialiased), non-square, and an axis already
    at 224, against jax.image.resize(..., "bicubic")."""
    x = np.random.default_rng(7).uniform(-1, 1, shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (shape[0], 224, 224, 3), method="bicubic")
    assert_close(TCL.resize_bicubic(t(x), 224), ref, TOL, ATOL, "resize")


def test_vision_tower_matches_jax(cfg):
    tree = _tree(lambda: JCL.init_vision_tower(jax.random.PRNGKey(0), cfg.clip_image), 13)
    images = np.random.default_rng(8).uniform(-1, 1, (2, 40, 72, 3)).astype(np.float32)
    ref = JCL.vision_tower_apply(to_jax(tree), cfg.clip_image, jnp.asarray(images))
    tower = port(TCL.VisionTower(TP.tiny().clip_image), tree)
    with torch.no_grad():
        ours = tower(t(images))
    assert ours.shape == (2, cfg.clip_image.tokens, cfg.clip_image.width)
    assert_close(ours, ref, TOL, ATOL, "vision tower")


def test_resampler_matches_jax(cfg):
    tree = _tree(lambda: JR.init_resampler(jax.random.PRNGKey(0), cfg.resampler), 14)
    x = np.random.default_rng(9).standard_normal(
        (2, cfg.clip_image.tokens, cfg.resampler.embedding_dim)).astype(np.float32)
    ref = JR.resampler_apply(to_jax(tree), cfg.resampler, jnp.asarray(x))
    res = port(TR.Resampler(TP.tiny().resampler), tree)
    with torch.no_grad():
        ours = res(t(x))
    assert ours.shape == (2, cfg.resampler.total_queries, cfg.resampler.output_dim)
    assert_close(ours, ref, TOL, ATOL, "resampler")


@pytest.fixture(scope="module")
def mdm_tree(cfg):
    return _tree(lambda: JMDM.init_mdm(jax.random.PRNGKey(0), cfg), 15)


def test_mdm_tree_loads_strictly(mdm_tree):
    """All five sub-models under the JAX tree's top-level keys."""
    mdm = port(TMDM.MDM(TP.tiny()), mdm_tree)
    tops = {k.split(".")[0] for k in mdm.state_dict()}
    assert tops == {"unet", "vae", "image_proj", "clip_text", "clip_image"}


def test_encode_conditions_and_embed_image_match_jax(cfg, mdm_tree):
    rng = np.random.default_rng(10)
    sparse = rng.uniform(-1, 1, (1, 4, 16, 16, 3)).astype(np.float32)
    depth = rng.uniform(-1, 1, (1, 4, 16, 16, 3)).astype(np.float32)
    params = to_jax(mdm_tree)
    ref_cc = JMDM.encode_conditions(params, cfg, jnp.asarray(sparse), jnp.asarray(depth))
    ref_img = JMDM.embed_image(params, cfg, jnp.asarray(sparse[:, 0]))
    mdm = port(TMDM.MDM(TP.tiny()), mdm_tree)
    with torch.no_grad():
        cc = TMDM.encode_conditions(mdm, t(sparse), t(depth))
        img = TMDM.embed_image(mdm, t(sparse[:, 0]))
    assert cc.shape == (1, 4, 8, 8, 8)
    assert_close(cc, ref_cc, TOL, ATOL, "encode_conditions")
    assert_close(img, ref_img, TOL, ATOL, "embed_image")
