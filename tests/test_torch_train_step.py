"""PyTorch port vs JAX for the MDM train step: two `make_train_step` steps
(accumulation 2, EMA, a clip that every step hits, the stage-2 temporal
freeze, a cosine schedule) against JAX `make_train_step(impl="xla",
remat=False, donate=False)` on the same batch, with the draws JAX made
passed in.

Tolerances: 1e-4 of the loss, 1e-3 of the gradient norm, and 5e-2 of the
learning rate for every parameter and EMA leaf (AdamW's first steps move
each element by about the learning rate whatever its gradient).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import torch

from mudg_tpu.models import mdm as JMDM
from mudg_tpu.train import step as JS
from mudg_tpu_torch import convert
from mudg_tpu_torch.models import mdm as TMDM
from mudg_tpu_torch.train import step as TS
from test_torch_util import (assert_close, jax_draws, port, port_training_cfg, t,
                             tiny_training_setup, to_jax, torch_batch)


def test_two_train_steps_match_jax(monkeypatch):
    """Two `make_train_step` steps (accumulation 2, EMA, a clip at 1e-3 that
    every step hits, the stage-2 temporal freeze, a cosine schedule over 4
    updates) against JAX `make_train_step(impl="xla", remat=False)` on the
    same batch and keys: loss and gradient norm of each step, then every
    parameter and EMA leaf. AdamW's first steps move each element by about
    the learning rate whatever its gradient, so the bound on parameters is
    a fraction of it."""
    cfg, tree, data, null_tokens = tiny_training_setup()
    tc_kw = dict(learning_rate=1e-3, grad_clip=1e-3, accum_steps=2, use_ema=True,
                 scheduler="cosine", decay_steps=4)
    monkeypatch.setattr(JS.M, "training_loss", functools.partial(
        JMDM.training_loss, compute_dtype=jnp.float32))   # the JAX step's default is bf16
    jtree = to_jax(tree)
    jtc = JS.TrainConfig(temporal_frozen=True, **tc_kw)
    trainable, frozen = JS.split_params(jtree)
    mask = JS.temporal_frozen_mask(cfg.unet, trainable["unet"])
    gm = {"unet": mask, "image_proj": jax.tree.map(lambda _: True, trainable["image_proj"])}
    jstep = JS.make_train_step(cfg, jtc, frozen, JMDM.schedule_arrays(cfg.schedule()),
                               jnp.asarray(null_tokens), grad_mask=gm, impl="xla", remat=False,
                               donate=False)
    jstate = JS.init_train_state(jtree, jtc)
    batch = data["accum"]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    mdm = port(TMDM.MDM(port_training_cfg(cfg)), tree)
    tc = TS.TrainConfig(**tc_kw)
    tmask = {"unet." + n: v for n, v in TS.temporal_frozen_mask(mdm.unet).items()}
    step = TS.make_train_step(mdm, tc, t(null_tokens).long(), grad_mask=tmask, impl="train",
                              remat=False, compute_dtype=torch.float32)
    state = TS.init_train_state(mdm, tc)
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        key = jax.random.PRNGKey(90 + i)
        jstate, jm = jstep(jstate, jbatch, key)
        keys = jax.random.split(key, tc.accum_steps)
        draws = [jax_draws(cfg, keys[j], {k: v[j] for k, v in batch.items()})
                 for j in range(tc.accum_steps)]
        state, m = step(state, torch_batch(batch), gen, draws)
        assert_close(m["loss"], jm["loss"], 1e-4, 0.0, f"loss {i}")
        assert float(jm["grad_norm"]) > 10 * tc.grad_clip       # the clip is hit
        assert_close(m["grad_norm"], jm["grad_norm"], 1e-3, 0.0, f"grad norm {i}")
    assert state.step == int(jstate.step) == 2 and state.count == 2
    for name, ours, ref in (("params", state.params, jstate.params),
                            ("ema", state.ema, jstate.ema_params)):
        sd = {**{"unet." + k: v for k, v in convert.tree_to_state_dict(ref["unet"]).items()},
              **{"image_proj." + k: v
                 for k, v in convert.tree_to_state_dict(ref["image_proj"]).items()}}
        assert set(sd) == set(ours)
        worst = max(float((ours[k].detach() - r).abs().max()) for k, r in sd.items())
        assert worst <= 0.05 * tc.learning_rate, (name, worst)
