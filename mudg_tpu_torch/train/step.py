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
`remat` takes False, True (full per-block recompute) or one of the
selective policies of `nn/remat.py`; the default is "dots_attn", as in the
JAX step.

Over several GPUs (`place_train_state`, step.py:104-170; one process per
GPU, `parallel/mesh.py`) each rank takes its rows of every global
microbatch, and of the random draws made at the global shape from the
generator that every rank holds alike, so that N ranks compute what one
process computes. After the microbatches the gradients are summed over the
ranks once per optimizer step, in flat fp32 buckets (`mesh.Buckets`), and
averaged over `data`; the global norm and the clip read the reduced
gradients, as optax does on the global batch. The layouts (`Layout`):
  * ZeRO-2 (the default): parameters and EMA whole on every rank, AdamW's
    mu and nu of every leaf of at least 2**14 elements cut along the dim
    JAX's `largest_divisible_axis_spec` picks; each rank updates its slice
    of each such parameter, and the slices are all-gathered;
  * FSDP (`fsdp=True`, ZeRO-3): parameters, moments, EMA and the frozen
    towers cut the same way with FSDP2 (`fully_shard`) over `data`, or over
    `seq` when sequence parallelism leaves no data axis; the units are the
    modules the forward calls (each UNet block layer, init_attn, the UNet's
    remainder, the resampler, the VAE's encoder and decoder, the towers), so
    that their hooks gather the weights that `nn/functional` reads, in the
    forward and again in a remat replay; leaves below 2**14 stay whole;
  * tensor parallelism (`tp_axis`, `parallel/tp.py`): the attention and
    feed-forward weights, their moments and EMA cut over `model`;
  * sequence parallelism (`sp`, `parallel/sp.py`): the UNet's activations
    cut over `seq`, its gradients summed over the seq ranks.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..models import mdm as M
from ..nn import remat as R
from ..nn.unet3d import block_plan
from ..parallel import mesh as PM

TRAINABLE = ("unet", "image_proj")
FROZEN = ("vae", "clip_text", "clip_image")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors mudg_tpu.train.step.TrainConfig (config.yaml:3,23,133,139-140).
    `scale_lr` multiplies the learning rate by the world batch only where
    one is given (`AdamW(tc, world_batch)`); the step builds its optimizer
    with none, as the JAX step does, so it changes nothing there.
    `temporal_frozen` is read by the training app, which then passes
    `temporal_frozen_mask` as `grad_mask`."""
    learning_rate: float = 1.0e-5
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    grad_clip: float = 0.5
    accum_steps: int = 2
    use_ema: bool = False
    ema_decay: float = 0.9999
    scale_lr: bool = False
    temporal_frozen: bool = False      # stage-2: freeze temporal layers
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
    layout: "Layout | None" = None   # how the state lies over the ranks (None: one process)


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
    decayed, as in optax. With `tc.scale_lr` and a `world_batch`, the
    learning rate is multiplied by it (trainer.py:91)."""

    def __init__(self, tc: TrainConfig, world_batch: int | None = None):
        self.tc = tc
        lr = tc.learning_rate
        if tc.scale_lr and world_batch:
            lr = lr * world_batch
        self.lr = make_lr_schedule(tc, lr)

    def init(self, params: dict):
        zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        return zeros, {n: z.clone() for n, z in zeros.items()}

    @torch.no_grad()
    def update(self, state: TrainState, grads: dict, gnorm: torch.Tensor,
               views=None) -> None:
        """views(name, param, grad) -> (the part of the parameter this rank
        updates in place, the matching part of the gradient); default the
        whole of both."""
        tc = self.tc
        # optax.clip_by_global_norm: g below the limit, else (g / norm) * limit
        clip = not bool(gnorm < tc.grad_clip)
        lr = self.lr(state.count)
        state.count += 1
        c1 = 1.0 - tc.beta1 ** state.count
        c2 = 1.0 - tc.beta2 ** state.count
        for n, p in state.params.items():
            g = grads[n]
            if views is not None:
                p, g = views(n, p, g)
            g = (g / gnorm) * tc.grad_clip if clip else g
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


# torch 2.13 renamed all_gather_into_tensor
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def fsdp_units(mdm: M.MDM):
    """The modules FSDP2 wraps, inner first: every layer of the UNet's
    input, middle and output blocks that the forward calls as a module,
    init_attn, the resampler, the VAE's encoder and decoder and the two
    towers; then the UNet itself (its embeddings, conv_in and out)."""
    unet = mdm.unet
    units = []
    for blocks in (list(unet.input_blocks.values()), [unet.middle_block],
                   list(unet.output_blocks.values())):
        for blk in blocks:
            units += [m for m in blk.values() if not isinstance(m, torch.nn.Conv2d)]
    if hasattr(unet, "init_attn"):
        units.append(unet.init_attn["0"])
    return units + [mdm.image_proj, mdm.vae.encoder, mdm.vae.decoder, mdm.clip_text,
                     mdm.clip_image, unet]


class Layout:
    """How a train state and its MDM lie over the ranks of a mesh
    (step.py:place_train_state). `place_train_state` builds it."""

    def __init__(self, mesh: PM.Mesh, *, fsdp=False, axis="data", tp_axis=None, sp=None,
                 min_size=PM.MIN_SIZE):
        self.mesh, self.fsdp, self.axis, self.sp = mesh, fsdp, axis, sp
        self.min_size = min_size
        self.n_data = mesh.shape.get("data", 1)
        self.data_group = mesh.group("data")
        self.tp_axis = tp_axis if tp_axis and mesh.shape.get(tp_axis, 1) > 1 else None
        self.tp = {}          # trainable name -> (dim, mode) of the TP cut
        self.zero = {}        # trainable name -> dim of the ZeRO-2 moment slices
        self.fsdp_dims = {}   # name -> dim FSDP cuts (trainable and frozen)
        self.fsdp_roots = []  # the FSDP2 modules over the trainable leaves
        self.n_fsdp = mesh.shape.get(axis, 1) if fsdp else 1
        self.fsdp_group = mesh.group(axis) if fsdp else None
        # the gradients of whole (not FSDP-managed) leaves are summed over
        # `grad_group` and divided by the data ranks: the data ranks hold
        # other samples, the seq ranks other positions of the same ones
        self.grad_group = mesh.all if sp is not None else self.data_group
        self.buckets = PM.Buckets()

    # -- the parts of a leaf ------------------------------------------------
    def param_view(self, name, p):
        """The part of parameter `name` this rank updates."""
        d = self.zero.get(name)
        return PM.local_slice(p, d, self.n_data, self.mesh.coord("data")) if d is not None \
            else PM.local_tensor(p)

    def local(self, kind: str, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole leaf: `kind` "params" or "ema" (the
        rank's parameter shard) or "mu"/"nu" (its moment slice)."""
        from ..parallel import tp as TP

        t = full
        if name in self.tp:
            dim, mode = self.tp[name]
            t = TP.local_block(t, dim, mode, self.mesh.shape[self.tp_axis],
                               self.mesh.coord(self.tp_axis))
        if name in self.fsdp_dims:
            t = PM.local_slice(t, self.fsdp_dims[name], self.n_fsdp, self.mesh.coord(self.axis))
        elif kind in ("mu", "nu") and name in self.zero:
            t = PM.local_slice(t, self.zero[name], self.n_data, self.mesh.coord("data"))
        return t.contiguous()

    def full(self, kind: str, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's part (collective over the
        mesh: every rank calls it for every leaf in the same order)."""
        from ..parallel import tp as TP

        t = PM.local_tensor(t).detach()
        if name in self.fsdp_dims:
            t = PM.gather_cat(t, self.fsdp_dims[name], self.fsdp_group, self.n_fsdp)
        elif kind in ("mu", "nu") and name in self.zero:
            t = PM.gather_cat(t, self.zero[name], self.data_group, self.n_data)
        if name in self.tp:
            dim, mode = self.tp[name]
            t = TP.full_weight(t, dim, mode, self.mesh.group(self.tp_axis),
                               self.mesh.shape[self.tp_axis])
        return t

    # -- the step's collectives -------------------------------------------
    def reduce_grads(self, grads: dict) -> None:
        """Sum the gradients over the ranks, in place: the whole leaves in
        buckets over grad_group, divided by the data ranks; the FSDP shards,
        which FSDP2 averaged over its axis, summed over the seq ranks (over
        that axis when it is seq, by undoing the mean)."""
        whole = [g for n, g in grads.items() if n not in self.fsdp_dims]
        self.buckets.all_reduce(whole, self.grad_group, float(self.n_data))
        if self.fsdp and self.sp is not None:
            shards = [g for n, g in grads.items() if n in self.fsdp_dims]
            if self.axis == self.sp.axis:
                for g in shards:   # FSDP2 averaged the seq ranks' parts: their sum
                    g.mul_(self.n_fsdp)
            else:
                PM.Buckets().all_reduce(shards, self.sp.group)

    def global_norm(self, grads: dict) -> torch.Tensor:
        """optax.global_norm of the whole gradients from the parts the
        ranks hold: whole leaves once, shards summed over their groups."""
        parts = {"whole": [], "fsdp": [], "tp": [], "both": []}
        for n, g in grads.items():
            key = {(False, False): "whole", (True, False): "fsdp", (False, True): "tp",
                   (True, True): "both"}[(n in self.fsdp_dims, n in self.tp)]
            parts[key].append(g)
        zero = torch.zeros((), device=next(iter(grads.values())).device)
        whole, fsdp, tp, both = (sum(((g.float() ** 2).sum() for g in v), zero)
                                 for v in parts.values())
        if self.fsdp:
            shards = torch.stack([fsdp, both])
            dist.all_reduce(shards, group=self.fsdp_group)
            fsdp, both = shards.unbind(0)
        if self.tp_axis:
            tp = tp + both
            dist.all_reduce(tp, group=self.mesh.group(self.tp_axis))
            return torch.sqrt(whole + fsdp + tp)
        return torch.sqrt(whole + fsdp + both)

    @torch.no_grad()
    def gather_zero(self, params: dict) -> None:
        """After each rank updated its ZeRO-2 slices: every parameter whole
        again, one all-gather per bucket."""
        names = [n for n in params if n in self.zero]
        n_ranks, i = self.n_data, self.mesh.coord("data")
        for bucket in PM.Buckets().plan([params[n] for n in names]):
            keys = names[:len(bucket)]
            names = names[len(bucket):]
            mine = [PM.local_slice(params[k], self.zero[k], n_ranks, i).contiguous()
                    for k in keys]
            flat = torch.cat([m.reshape(-1) for m in mine])
            got = torch.empty(n_ranks * flat.numel(), dtype=flat.dtype, device=flat.device)
            _all_gather_single(got, flat, group=self.data_group)
            got = got.view(n_ranks, -1)
            off = 0
            for k, m in zip(keys, mine):
                pieces = got[:, off:off + m.numel()].reshape(n_ranks, *m.shape)
                params[k].copy_(torch.cat(pieces.unbind(0), dim=self.zero[k]))
                off += m.numel()


def _fsdp_wrap(mdm: M.MDM, layout: Layout, shapes: dict) -> None:
    """FSDP2 over the layout's axis on `fsdp_units`, each leaf cut along
    its dim of `layout.fsdp_dims` (filled here), the leaves without one
    left whole (ignored by FSDP2)."""
    import warnings

    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from ..parallel import tp as TP

    # the units return reshaped views; nothing changes them in place
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module .* returned a view")
    n = layout.n_fsdp
    dims = {}
    for name, p in mdm.named_parameters():
        if name.startswith("unet.") and layout.tp_axis:
            # the data dim JAX picks beside its TP dim, also where the port
            # keeps a layer whole for its heads
            _, d = TP.unet_tp_fsdp_shardings(
                {name[5:]: shapes[name]}, layout.mesh.shape[layout.tp_axis], n,
                layout.min_size)[name[5:]]
        else:
            d = PM.zero_dim(name, shapes[name], n, layout.min_size)
        if d is not None:
            dims[id(p)] = (name, d)
    layout.fsdp_dims = {name: d for name, d in dims.values()}
    layout.fsdp_roots = [mdm.unet, mdm.image_proj]
    ignored = {p for p in mdm.parameters() if id(p) not in dims}
    dmesh = layout.mesh.device_mesh(layout.axis, next(mdm.parameters()).device.type)

    def place(p):
        return Shard(dims[id(p)][1])

    for unit in fsdp_units(mdm):
        fully_shard(unit, mesh=dmesh, shard_placement_fn=place,
                    ignored_params=ignored & set(unit.parameters()))
        R.exempt_hooks(unit)


def place_train_state(mdm: M.MDM, tc: TrainConfig, mesh: PM.Mesh, *, fsdp: bool = False,
                      axis: str = "data", tp_axis: str | None = None, sp=None,
                      min_size: int = PM.MIN_SIZE) -> TrainState:
    """The train state of `mdm` laid over `mesh` (step.py:104-170), the
    model cut in place first: with `tp_axis` of more than one rank the
    UNet's attention and FF weights over it (`parallel/tp.py`); with `fsdp`
    parameters, EMA and frozen towers over `axis` (FSDP2); the moments
    ZeRO-2 over `data` otherwise (like the parameters under TP or FSDP). `sp`
    is the sequence-parallel sharding the step then runs the UNet under.
    Each rank's dropout draws its own masks (`UNet3D.dropout_rank`: its
    data and seq coordinates; the model ranks of a group draw alike, as
    they hold the same activations). Every rank calls it alike."""
    from ..parallel import tp as TP

    layout = Layout(mesh, fsdp=fsdp, axis=axis, tp_axis=tp_axis, sp=sp, min_size=min_size)
    shapes = {n: tuple(p.shape) for n, p in mdm.named_parameters()}
    for k in FROZEN:
        getattr(mdm, k).requires_grad_(False)
    if layout.tp_axis:
        cut = TP.shard_unet_tp(mdm.unet, mesh, layout.tp_axis)
        layout.tp = {"unet." + k: v for k, v in cut.items()}
    if fsdp:
        _fsdp_wrap(mdm, layout, shapes)
    elif not layout.tp_axis:
        layout.zero = {n: d for n in trainable_params(mdm)
                       if (d := PM.zero_dim(n, shapes[n], layout.n_data, min_size)) is not None}
    n_seq = sp.n if sp is not None else 1
    mdm.unet.dropout_rank = mesh.coord("data") * n_seq + (sp.index if sp is not None else 0)
    params = trainable_params(mdm)
    with torch.no_grad():
        mu = {n: torch.zeros_like(layout.param_view(n, p), dtype=torch.float32)
              for n, p in params.items()}
        nu = {n: z.clone() for n, z in mu.items()}
        ema = ({n: PM.local_tensor(p).detach().clone() for n, p in params.items()}
               if tc.use_ema else None)
    return TrainState(params, mu, nu, 0, ema, 0, layout)


def shard_draws(draws: dict, n: int, i: int) -> dict:
    """Rank i of n's rows of a global microbatch's draws: dim 0 of each,
    and of each third of the stacked posterior draw (dense, sparse and
    depth; the dense frames alone in interp mode)."""
    if n == 1:
        return draws
    b = draws["t"].shape[0]
    lo, hi = PM.block(b, n, i)
    out = {k: v[lo:hi] for k, v in draws.items() if k != "posterior_eps"}
    eps = draws["posterior_eps"]
    if eps.shape[0] == b:
        out["posterior_eps"] = eps[lo:hi]
    else:
        out["posterior_eps"] = eps.reshape(3, b, *eps.shape[1:])[:, lo:hi].reshape(
            3 * (hi - lo), *eps.shape[1:])
    return out


def local_params(state: TrainState) -> dict:
    """name -> the tensor of each trainable parameter this rank holds (its
    FSDP or TP shard; the whole otherwise)."""
    return {n: PM.local_tensor(p) for n, p in state.params.items()}


def make_train_step(mdm: M.MDM, tc: TrainConfig, null_tokens, *, grad_mask: dict | None = None,
                    impl: str = "train", remat: bool | str = "dots_attn",
                    compute_dtype=torch.bfloat16):
    """The train step: step(state, batch, generator, draws=None) -> (state,
    {"loss", "grad_norm"}) (step.py:220-326).

    With tc.accum_steps > 1 every batch leaf has a leading microbatch axis
    (accum, B, ...); the microbatches' losses and gradients are averaged
    before one optimizer update. The generator draws each microbatch's
    `draw_training_noise` (unless `draws`, one dict per microbatch, is
    given) and the UNet's dropout. grad_mask: trainable name -> False for
    leaves whose gradient is zeroed (`temporal_frozen_mask`). remat: False,
    True or a policy name of `nn/remat.POLICIES`. The null prompt's
    embedding is encoded once here. The frozen towers get requires_grad
    False.

    A state from `place_train_state` runs over its ranks: `batch` is then
    this rank's rows of the data (`mesh.shard_batch`) and the draws are made
    (or given) at the global microbatch, each rank taking its rows; the
    loss is averaged over the data ranks. Every rank calls the step alike."""
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
        lay = state.layout
        n_data = lay.n_data if lay is not None else 1
        i_data = lay.mesh.coord("data") if lay is not None else 0
        sp = lay.sp if lay is not None else None
        n_micro = tc.accum_steps
        micro = ([batch] if n_micro == 1 else
                 [{k: v[i] for k, v in batch.items()} for i in range(n_micro)])
        for p in state.params.values():
            p.grad = None
        loss_sum = torch.zeros((), device=device)
        for i, mb in enumerate(micro):
            if draws is not None:
                d = draws[i]
            else:
                shapes = M.training_shapes(cfg, mb)
                b = shapes["latent"][0] * n_data   # the global microbatch
                shapes = {"latent": (b,) + shapes["latent"][1:],
                          "posterior": (shapes["posterior"][0] * n_data,)
                          + shapes["posterior"][1:]}
                d = M.draw_training_noise(cfg, shapes, generator)
            d = shard_draws(d, n_data, i_data)
            for root in (lay.fsdp_roots if lay is not None else ()):
                # FSDP2 accumulates unsharded and reduce-scatters once, after the last
                root.set_requires_gradient_sync(i == n_micro - 1)
            with torch.enable_grad():
                loss, _ = M.training_loss(mdm, mb, d, null_emb=null_emb, sched_arrays=sched,
                                          impl=impl, remat=remat, compute_dtype=compute_dtype,
                                          generator=generator, sp=sp)
                loss.backward()
            loss_sum += loss.detach()
        grads = {}
        for n, p in state.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = PM.local_tensor(g) / n_micro
            grads[n] = g * mask[n] if mask is not None else g
            p.grad = None
        loss = loss_sum / n_micro
        views = None
        if lay is None:
            gnorm = global_norm(grads.values())
        else:
            lay.reduce_grads(grads)
            if n_data > 1:
                dist.all_reduce(loss, group=lay.data_group)
                loss /= n_data
            gnorm = (global_norm(grads.values()) if not (lay.fsdp or lay.tp_axis)
                     else lay.global_norm(grads))
            views = (lambda n, p, g: (lay.param_view(n, p),
                                      PM.local_slice(g, lay.zero.get(n), n_data, i_data)))
        opt.update(state, grads, gnorm, views)
        if lay is not None and lay.zero:
            lay.gather_zero(state.params)
        if state.ema is not None:
            ema_update(state.ema, local_params(state), state.step, tc.ema_decay)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return step
