"""The plain reference of MuDG's training step, in float32.

The v-prediction loss of the MDM (DynamiCrafter's shared_step / p_losses
with MuDG's conditioning: one VAE encode of the dense target, the sparse
color and the sparse depth video, a posterior sample of each, the 5 / 5 / 5
% text / image / both dropout of the conditions, the dynamic latent
rescale, q-sampling, the UNet with dropout 0.1 in its residual blocks),
its gradients over the trainable set (UNet and resampler; the VAE and the
CLIP towers frozen), the mean over the micro-batches, the global-norm clip
and AdamW. The random draws are the step's, replayed from the generator's
state in the order the step makes them: per micro-batch the timesteps, the
diffusion noise, the posterior noise, the dropout uniforms, the offset
noise, then the UNet's per-block dropout seeds; each block's masks come
from a generator seeded with its seed.

Each sample's loss is formed and differentiated on its own (the batch's
loss is the mean of the samples'), every UNet block under
torch.utils.checkpoint, so that the reference fits beside the program's
freed state. Imports nothing of the program under test.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import mdm as R
from . import sampler as RS


def train_tables(cfg: dict, device) -> dict:
    """sqrt(alphas_cumprod), sqrt(1 - alphas_cumprod) and the dynamic
    rescale, float32, indexed by timestep."""
    sch = RS.schedule(cfg)
    ac = sch["alphas_cumprod"]
    return {k: torch.as_tensor(np.asarray(a, np.float32), device=device)
            for k, a in (("sa", np.sqrt(ac)), ("soma", np.sqrt(1.0 - ac)),
                         ("scale", sch["scale"]))}


def draws(cfg: dict, batch: int, frames: int, h: int, w: int, generator: torch.Generator):
    """One micro-batch's draws from `generator`, in the step's order."""
    z = cfg["vae"]["embed_dim"]
    lat = (batch, frames, h, w, z)
    kw = dict(generator=generator, device=generator.device)
    d = {"t": torch.randint(0, cfg["timesteps"], (batch,), **kw),
         "noise": torch.randn(lat, **kw),
         "posterior_eps": torch.randn((3 * batch,) + lat[1:], **kw),
         "cfg_uniform": torch.rand((batch,), **kw),
         "offset_noise": torch.randn((batch, frames, 1, 1, z), **kw)}
    if cfg["unet"]["dropout"] > 0:
        inp, mid, out = R.unet_plan(cfg["unet"])
        d["seeds"] = torch.randint(0, 2 ** 62, (len(inp) + 1 + len(out),), **kw).tolist()
    return d


class Dropout:
    """A block's dropout: masks drawn at the whole batch's shape from the
    block's generator, in the block's order, the rows of `sample` kept."""

    def __init__(self, seed, rate, batch, sample, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.rate, self.batch, self.sample = rate, batch, sample

    def __call__(self, x, rows):
        """x holds `rows` rows of the sample of a layer whose batch holds
        batch * rows."""
        full = (self.batch * rows,) + tuple(x.shape[1:])
        keep = torch.rand(full, generator=self.gen, device=x.device)
        keep = keep[self.sample * rows:(self.sample + 1) * rows] < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), device=x.device))


def _res_drop(P, name, x, emb, frames, drop):
    h = R.conv2d(P, name + ".in_layers.2", F.silu(R.group_norm(P, name + ".in_layers.0", x, 1e-5)))
    h = h + R.linear(P, name + ".emb_layers.1", F.silu(emb))[:, None, None, :]
    h = F.silu(R.group_norm(P, name + ".out_layers.0", h, 1e-5))
    h = R.conv2d(P, name + ".out_layers.3", drop(h, frames))
    if name + ".skip_connection.weight" in P:
        x = R.conv2d(P, name + ".skip_connection", x)
    h = x + h
    n, hh, ww, c = h.shape
    v = h.reshape(1, n, hh, ww, c)
    t = v
    for i in range(1, 5):
        s = f"{name}.temopral_conv.conv{i}"
        t = F.silu(R.group_norm(P, s + ".0", t, 1e-5))
        if i > 1:
            t = drop(t, 1)
        wk = s + (".2" if i == 1 else ".3")
        t = F.conv3d(R.lowered(t).permute(0, 4, 1, 2, 3), R.lowered(P[wk + ".weight"]),
                     P[wk + ".bias"], padding=(1, 0, 0)).permute(0, 2, 3, 4, 1)
    return (v + t).reshape(n, hh, ww, c)


def unet_train(P, u: dict, x, t, context, label, fs, seeds, batch, sample):
    """The UNet of one sample (x (1, T, h, w, in)) in training: dropout at
    u["dropout"] in each residual block (before its output conv and before
    the conv of temporal stages 2-4), masks of the whole batch's shape from
    each block's seed, every block checkpointed."""
    nt, hh, ww = x.shape[1:4]
    mc, dh = u["model_channels"], u["num_head_channels"]
    Q = {k[5:]: v for k, v in P.items() if k.startswith("unet.")}

    def mlp(name, v):
        return R.linear(Q, name + ".2", F.silu(R.linear(Q, name + ".0", v)))

    emb = mlp("time_embed", R.timestep_embedding(t, mc))
    emb = emb + mlp("class_embed", R.timestep_embedding(label, mc))
    tl, ipf = u["text_context_len"], u["image_tokens_per_frame"]
    ctx = torch.cat([context[:, :tl].repeat_interleave(nt, 0),
                     context[:, tl:].reshape(nt, ipf, -1)], dim=1)
    emb = emb.repeat_interleave(nt, 0)
    emb = emb + mlp("fps_embedding", R.timestep_embedding(fs, mc)).repeat_interleave(nt, 0)
    h = x.reshape(nt, hh, ww, x.shape[-1])
    seeds = iter(seeds)

    def block(name, plan, h, seed):
        drop = Dropout(seed, u["dropout"], batch, sample, h.device)
        for j, (lt, _) in enumerate(plan):
            m = f"{name}.{j}"
            if lt == "res":
                h = _res_drop(Q, m, h, emb, nt, drop)
            else:
                h = _layer(Q, m, lt, h, ctx, dh)
        return h

    def run(name, plan, h):
        return checkpoint(block, name, plan, h, next(seeds), use_reentrant=False)

    inp, mid, out = R.unet_plan(u)
    hs = []
    for i, plan in enumerate(inp):
        h = run(f"input_blocks.{i}", plan, h)
        if i == 0:
            n, h_, w_, c = h.shape
            h = R._temporal(Q, "init_attn.0", h.reshape(1, n, h_, w_, c), dh).reshape(n, h_, w_, c)
        hs.append(h)
    h = run("middle_block", mid, h)
    for i, plan in enumerate(out):
        h = run(f"output_blocks.{i}", plan, torch.cat([h, hs.pop()], -1))
    h = R.conv2d(Q, "out.2", F.silu(R.group_norm(Q, "out.0", h, 1e-5)))
    return h.reshape(1, nt, hh, ww, -1)


def _layer(Q, m, lt, h, ctx, dh):
    if lt == "conv_in":
        return R.conv2d(Q, m, h)
    if lt == "spatial":
        return R._spatial(Q, m, h, ctx, dh)
    if lt == "temporal":
        n, hh, ww, c = h.shape
        return R._temporal(Q, m, h.reshape(1, n, hh, ww, c), dh).reshape(n, hh, ww, c)
    if lt == "down":
        return R.conv2d(Q, m + ".op", h, stride=2, pad=(1, 1, 1, 1))
    return R.conv2d(Q, m + ".conv", h.repeat_interleave(2, 1).repeat_interleave(2, 2))


def sample_loss(P, cfg: dict, mb: dict, d: dict, tables: dict, b: int, null_emb):
    """The loss of sample b of micro-batch `mb` (host arrays of the loader)
    with the micro-batch's draws `d`, divided by the micro-batch's size."""
    u, v = cfg["unet"], cfg["vae"]
    dev = null_emb.device
    batch = mb["dense_frames"].shape[0]
    frames = mb["dense_frames"].shape[1]
    with torch.no_grad():
        vids = [torch.as_tensor(mb[k][b], device=dev).float()
                for k in ("dense_frames", "sparse_frames", "sparse_depth")]
        zs = []
        for j, x in enumerate(vids):
            m = torch.cat([R.vae_moments(P, v, x[i:i + 4]) for i in range(0, frames, 4)])
            mean, logvar = m.chunk(2, -1)
            eps = d["posterior_eps"][j * batch + b]
            zs.append(v["scale_factor"] * (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps))
        z, sz, dz = zs
        c_concat = torch.cat([sz, dz], -1)
        tokens = torch.as_tensor(mb["tokens"][b:b + 1], device=dev).long()
        cond = R.text_encode(P, cfg["clip_text"], tokens)
        uval = float(d["cfg_uniform"][b])
        p = cfg["uncond_prob"]
        prompt = null_emb if uval < 2 * p else cond
        keep_img = 0.0 if p <= uval < 3 * p else 1.0
        img_tokens = R.image_encode(P, cfg["clip_image"], vids[1][:1] * keep_img)
    img_emb = R.resample(P, cfg["resampler"], img_tokens)
    context = torch.cat([prompt, img_emb], 1)
    t = d["t"][b:b + 1]
    z = z * tables["scale"][t]
    noise = d["noise"][b]
    z_noisy = tables["sa"][t] * z + tables["soma"][t] * noise
    target = tables["sa"][t] * noise - tables["soma"][t] * z
    label = torch.as_tensor(mb["class_label"][b:b + 1], device=dev).long()
    fs = torch.as_tensor(mb["fps"][b:b + 1], device=dev).long()
    x = torch.cat([z_noisy, c_concat], -1)[None]
    v_pred = unet_train(P, u, x, t, context, label, fs, d.get("seeds", []), batch, b)
    return ((v_pred[0] - target) ** 2).mean() / batch


TRAINABLE = ("unet.", "image_proj.")


def adamw_step(params: dict, grads: dict, mu: dict, nu: dict, count: int, tc: dict) -> float:
    """Global-norm clip, then one AdamW update in place (bias-corrected
    moments, decoupled weight decay); returns the gradients' global norm."""
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    scale = tc["grad_clip"] / gnorm if not gnorm < tc["grad_clip"] else 1.0
    b1, b2 = tc["beta1"], tc["beta2"]
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    for n, p in params.items():
        g = grads[n] * scale
        mu[n].mul_(b1).add_(g, alpha=1 - b1)
        nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + 1e-8) + tc["weight_decay"] * p
        p.sub_(tc["learning_rate"] * upd)
    return gnorm
