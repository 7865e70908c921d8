"""The training step: AdamW with global-norm clipping, gradient accumulation,
the stage-2 temporal freeze, LR schedules and the LitEma shadow.

Port of `mudg_tpu/train/step.py` (reference `main/trainer.py` and
`ddpm3d.py:1267-1292`): AdamW(lr 1e-5, 0.9, 0.999, weight decay 0.01),
global-norm clip 0.5, accumulation over 2 microbatches, trainable set UNet +
image projector (the VAE and CLIP towers frozen), EMA decay with the warmup
min(decay, (1 + n) / (10 + n)). The optimizer repeats optax's arithmetic
(clip_by_global_norm, scale_by_adam, add_decayed_weights, the schedule read
at the update count) so that a step equals the JAX step's.

The parameters are the modules' own fp32 tensors, updated in place (the
JAX step returns new arrays; in place saves a copy of 1.44B parameters).
The mesh placement (ZeRO, FSDP, tensor and sequence parallelism) waits for
the multi-GPU slice, the remat policies other than full recompute for their
own PR.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models import mdm as M
from ..nn.unet3d import block_plan

TRAINABLE = ("unet", "image_proj")
FROZEN = ("vae", "clip_text", "clip_image")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors mudg_tpu.train.step.TrainConfig (config.yaml:3,23,133,139-140),
    less the two fields that only the training app reads (`scale_lr`, which
    needs the world batch, and `temporal_frozen`, which selects the
    `temporal_frozen_mask` it passes as `grad_mask`); they come with the
    app."""
    learning_rate: float = 1.0e-5
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    grad_clip: float = 0.5
    accum_steps: int = 2
    use_ema: bool = False
    ema_decay: float = 0.9999
    # None (constant), "lambda_warmup" or "cosine" (ddpm3d.py:1007-1031)
    scheduler: str | None = None
    warmup_steps: int = 1000
    decay_steps: int = 100000
    min_lr_ratio: float = 0.0


@dataclasses.dataclass
class TrainState:
    params: dict          # trainable name -> the module's fp32 parameter
    mu: dict              # AdamW first moments
    nu: dict              # AdamW second moments
    count: int            # optimizer updates so far
    ema: dict | None      # LitEma shadow of params
    step: int


def trainable_params(mdm: M.MDM) -> dict:
    """The trainable set, UNet + image_proj, as "unet.*" / "image_proj.*"."""
    return {f"{k}.{n}": p for k in TRAINABLE for n, p in getattr(mdm, k).named_parameters()}


def temporal_frozen_mask(unet) -> dict:
    """name -> trainable over the UNet's parameters under stage-2 temporal
    freezing (step.py:73-101): the per-level TemporalTransformers are frozen,
    init_attn and the temporal convs stay trainable."""
    inp, mid, out = block_plan(unet.cfg)
    frozen = [f"input_blocks.{i}.{j}." for i, plan in enumerate(inp)
              for j, (lt, _) in enumerate(plan) if lt == "temporal"]
    frozen += [f"middle_block.{j}." for j, (lt, _) in enumerate(mid) if lt == "temporal"]
    frozen += [f"output_blocks.{i}.{j}." for i, plan in enumerate(out)
               for j, (lt, _) in enumerate(plan) if lt == "temporal"]
    return {n: not n.startswith(tuple(frozen)) for n, _ in unet.named_parameters()}


def make_lr_schedule(tc: TrainConfig, lr: float):
    """count -> learning rate (step.py:182-192): constant, the LambdaLR
    linear warmup, or optax's cosine_decay_schedule."""
    if tc.scheduler is None:
        return lambda count: lr
    if tc.scheduler == "lambda_warmup":
        return lambda count: lr * min((count + 1.0) / max(tc.warmup_steps, 1), 1.0)
    if tc.scheduler == "cosine":
        def cosine(count):
            frac = min(count, tc.decay_steps) / tc.decay_steps
            return lr * ((1 - tc.min_lr_ratio) * 0.5 * (1 + math.cos(math.pi * frac))
                         + tc.min_lr_ratio)
        return cosine
    raise NotImplementedError(f"scheduler {tc.scheduler!r}")


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay)) in place on the parameters (step.py:195-203). A leaf whose
    gradient is masked to 0 keeps its moments decaying and is still weight
    decayed, as in optax."""

    def __init__(self, tc: TrainConfig):
        self.tc = tc
        self.lr = make_lr_schedule(tc, tc.learning_rate)

    def init(self, params: dict):
        zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        return zeros, {n: z.clone() for n, z in zeros.items()}

    @torch.no_grad()
    def update(self, state: TrainState, grads: dict, gnorm: torch.Tensor) -> None:
        tc = self.tc
        # optax.clip_by_global_norm: g below the limit, else (g / norm) * limit
        clip = not bool(gnorm < tc.grad_clip)
        lr = self.lr(state.count)
        state.count += 1
        c1 = 1.0 - tc.beta1 ** state.count
        c2 = 1.0 - tc.beta2 ** state.count
        for n, p in state.params.items():
            g = (grads[n] / gnorm) * tc.grad_clip if clip else grads[n]
            mu, nu = state.mu[n], state.nu[n]
            mu.mul_(tc.beta1).add_(g, alpha=1.0 - tc.beta1)
            nu.mul_(tc.beta2).addcmul_(g, g, value=1.0 - tc.beta2)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + 1e-8) + tc.weight_decay * p
            p.sub_(lr * upd)


def ema_update(ema: dict, params: dict, step: int, decay: float = 0.9999) -> None:
    """LitEma shadow update with warmup (lvdm/ema.py:29-41), in place."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    with torch.no_grad():
        for n, e in ema.items():
            e.sub_((1.0 - d) * (e - params[n]))


def init_train_state(mdm: M.MDM, tc: TrainConfig) -> TrainState:
    params = trainable_params(mdm)
    mu, nu = AdamW(tc).init(params)
    ema = {n: p.detach().clone() for n, p in params.items()} if tc.use_ema else None
    return TrainState(params, mu, nu, 0, ema, 0)


def make_train_step(mdm: M.MDM, tc: TrainConfig, null_tokens, *, grad_mask: dict | None = None,
                    impl: str = "train", remat: bool = True,
                    compute_dtype=torch.bfloat16):
    """The train step: step(state, batch, generator, draws=None) -> (state,
    {"loss", "grad_norm"}) (step.py:220-326).

    With tc.accum_steps > 1 every batch leaf has a leading microbatch axis
    (accum, B, ...); the microbatches' losses and gradients are averaged
    before one optimizer update. The generator draws each microbatch's
    `draw_training_noise` (unless `draws`, one dict per microbatch, is
    given) and the UNet's dropout. grad_mask: trainable name -> False for
    leaves whose gradient is zeroed (`temporal_frozen_mask`). The null
    prompt's embedding is encoded once here. The frozen towers get
    requires_grad False."""
    cfg = mdm.cfg
    for k in FROZEN:
        getattr(mdm, k).requires_grad_(False)
    device = next(mdm.unet.parameters()).device
    sched = M.schedule_arrays(cfg.schedule(), device)
    with torch.no_grad():
        null_emb = M.encode_text(mdm, null_tokens[None])
    opt = AdamW(tc)
    names = list(trainable_params(mdm))
    mask = {n: float(grad_mask.get(n, True)) for n in names} if grad_mask is not None else None

    def step(state: TrainState, batch: dict, generator: torch.Generator, draws=None):
        n_micro = tc.accum_steps
        micro = ([batch] if n_micro == 1 else
                 [{k: v[i] for k, v in batch.items()} for i in range(n_micro)])
        for p in state.params.values():
            p.grad = None
        loss_sum = torch.zeros((), device=device)
        for i, mb in enumerate(micro):
            d = (draws[i] if draws is not None else
                 M.draw_training_noise(cfg, M.training_shapes(cfg, mb), generator))
            with torch.enable_grad():
                loss, _ = M.training_loss(mdm, mb, d, null_emb=null_emb, sched_arrays=sched,
                                          impl=impl, remat=remat, compute_dtype=compute_dtype,
                                          generator=generator)
                loss.backward()
            loss_sum += loss.detach()
        grads = {}
        for n, p in state.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = g / n_micro
            grads[n] = g * mask[n] if mask is not None else g
            p.grad = None
        gnorm = global_norm(grads.values())
        opt.update(state, grads, gnorm)
        if state.ema is not None:
            ema_update(state.ema, state.params, state.step, tc.ema_decay)
        state.step += 1
        return state, {"loss": loss_sum / n_micro, "grad_norm": gnorm}

    return step
