"""PyTorch port vs JAX for the MDM training loss: `training_loss` in its
pixel, moments and frame-interpolation forms, the loss and every trainable
gradient against `jax.value_and_grad` of the JAX function (impl "xla", no
remat, fp32 compute) with the draws JAX made passed in.

Tolerances: 1e-4 of the loss; per gradient leaf 2e-3 * max|ref| plus 1e-5
of the largest gradient of its sub-model (tests/test_reference_oracle.py:50
for fp32 compositions).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from mudg_tpu.models import mdm as JMDM
from mudg_tpu.train import step as JS
from mudg_tpu_torch import convert
from mudg_tpu_torch.models import mdm as TMDM
from mudg_tpu_torch.train import step as TS
from test_torch_util import (B, assert_close, jax_draws, port, port_training_cfg, t,
                             tiny_training_setup, to_jax, torch_batch)

TOL = 2e-3


@pytest.fixture(scope="module")
def tiny():
    return tiny_training_setup()


def _key_with_cfg_drop(lo, hi):
    """The first PRNGKey(s) whose CFG-dropout uniform falls in [lo, hi), so
    that the test walks a dropped branch."""
    for s in range(200):
        u = float(jax.random.uniform(jax.random.split(jax.random.PRNGKey(s), 7)[2], (B,))[0])
        if lo <= u < hi:
            return jax.random.PRNGKey(s)
    raise AssertionError("no key found")


def _assert_grads_match(module, ref_tree, name):
    ours = {n: p.grad for n, p in module.named_parameters()}
    ref = convert.tree_to_state_dict(ref_tree)
    assert set(ours) == set(ref), name
    scale = max(float(r.abs().max()) for r in ref.values())
    for k, r in ref.items():
        assert ours[k] is not None, f"{name}.{k}: no gradient"
        # per leaf: 2e-3 of the leaf's own scale, plus 1e-5 of the largest
        # gradient for leaves whose gradient is all but zero
        assert_close(ours[k], r.numpy(), TOL, 1e-5 * scale, f"{name}.{k}")


@pytest.mark.parametrize("form", ["pixels", "moments", "interp"])
def test_training_loss_and_grads_match_jax(tiny, form):
    """`training_loss` against `jax.value_and_grad` of the JAX function
    (impl "xla", no remat, fp32 compute) with the draws JAX made: the loss
    and the gradient of every UNet and resampler parameter. The pixel form
    (one stacked encode, chunked) drops the image condition, the moments
    form drops the prompt and the image and adds offset noise and the ELBO
    term. The interp form, which conditions on the first and last latent
    frames, differs from the pixel form only before the UNet, where nothing
    carries a gradient: its loss alone is compared."""
    cfg, tree, data, null_tokens = tiny
    cfg = {"pixels": cfg,
           "moments": dataclasses.replace(cfg, noise_strength=0.1, original_elbo_weight=0.5),
           "interp": dataclasses.replace(cfg, interp_mode=True)}[form]
    batch = data["moments" if form == "moments" else "pixels"]
    p = cfg.uncond_prob
    key = (_key_with_cfg_drop(2 * p, 3 * p) if form == "pixels" else
           _key_with_cfg_drop(p, 2 * p) if form == "moments" else jax.random.PRNGKey(3))
    jtree = to_jax(tree)
    trainable, frozen = JS.split_params(jtree)
    sched = JMDM.schedule_arrays(cfg.schedule())

    def loss_fn(tr):
        return JMDM.training_loss(JS.merge_params(tr, frozen), cfg, sched,
                                  {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                  null_tokens=jnp.asarray(null_tokens), impl="xla", remat=False,
                                  compute_dtype=jnp.float32)[0]

    with_grads = form != "interp"
    if with_grads:
        loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    else:
        loss_ref = jax.jit(loss_fn)(trainable)
    mdm = port(TMDM.MDM(port_training_cfg(cfg)), tree)
    with torch.set_grad_enabled(with_grads):
        loss, metrics = TMDM.training_loss(
            mdm, torch_batch(batch), jax_draws(cfg, key, batch),
            null_tokens=t(null_tokens).long(), impl="train", remat=False,
            compute_dtype=torch.float32)
    assert loss.dtype == torch.float32 and metrics["loss_simple"] > 0
    assert_close(loss, loss_ref, 1e-4, 0.0, "loss")
    if not with_grads:
        return
    loss.backward()
    _assert_grads_match(mdm.unet, grads_ref["unet"], "unet")
    _assert_grads_match(mdm.image_proj, grads_ref["image_proj"], "image_proj")
    for k in TS.FROZEN:
        assert all(p.grad is None for p in getattr(mdm, k).parameters()), k
