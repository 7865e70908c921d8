"""The MDM (multi-modal diffusion model): conditioning assembly, the
training loss and guided sampling.

Port of `mudg_tpu/models/mdm.py` (reference LatentVisualDiffusion,
`lvdm/models/ddpm3d.py:1033-1300`, and the condition assembly of
`virtual_render/virtual_pose_render.py:62-147`). Videos are
(B, T, H, W, 3) channels-last in [-1, 1], latents (B, T, h, w, 4);
  c_concat    = cat(sparse_rgb_z, sparse_depth_z) over channels (B, T, h, w, 8)
  c_crossattn = cat(text_emb (B, 77, 1024), img_emb (B, T*16, 1024))
CFG variants are stacked on the batch axis, so each sampler step is one UNet
call at batch n_variants*B. `sample` is the whole path from pixels and token
ids to the clip; `sample_clip` is its second half with the context given.
`training_loss` is the shared_step / p_losses of the reference; its random
draws are explicit (`draw_training_noise`), so that a caller can pass the
draws another implementation made. `sp` (a `parallel/sp.SeqSharding`) runs
the UNet sequence-parallel in `training_loss` and `sample`, and in `sample`
the frozen VAE's encode and decode on a block of the frames each, gathered
after (mdm.py:401-402,454); the DDIM state stays whole on every rank.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch
from torch import nn

from ..conditioning import clip as CL
from ..core import diffusion as D
from ..core.distributions import DiagonalGaussian
from ..core import schedules as S
from ..diffusion import ddim, dpm
from ..nn import resampler as R
from ..nn import unet3d as U
from ..nn import vae as V
from ..parallel import sp as SP
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class MDMConfig:
    """Sub-model configs + diffusion hyperparameters
    (configs/stage1-512_mdm_waymo/config.yaml), as mudg_tpu.models.mdm."""
    unet: U.UNetConfig = dataclasses.field(default_factory=U.UNetConfig)
    vae: V.VAEConfig = dataclasses.field(default_factory=V.VAEConfig)
    resampler: R.ResamplerConfig = dataclasses.field(default_factory=R.ResamplerConfig)
    clip_text: CL.TextConfig = dataclasses.field(default_factory=CL.TextConfig)
    clip_image: CL.VisionConfig = dataclasses.field(default_factory=CL.VisionConfig)
    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.00085
    linear_end: float = 0.012
    rescale_betas_zero_snr: bool = True
    parameterization: str = "v"
    use_dynamic_rescale: bool = True
    base_scale: float = 0.7          # 0.3 for the stage-2 (1024) config
    turning_step: int = 400
    default_fs: int = 10
    vae_chunk: int = 1               # frames per VAE call (perframe_ae)
    # training (mdm.py:57-74)
    uncond_prob: float = 0.05        # each of the text / image / both CFG drops
    train_encode_chunk: int = 16     # frames per call of the stacked training encode
    noise_strength: float = 0.0      # offset noise (ddpm3d.py:742-745)
    interp_mode: bool = False        # frame-interpolation conditioning (ddpm3d.py:1114-1118)
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0

    def schedule(self) -> S.DiffusionSchedule:
        return S.DiffusionSchedule.create(
            timesteps=self.timesteps, beta_schedule=self.beta_schedule,
            linear_start=self.linear_start, linear_end=self.linear_end,
            rescale_betas_zero_snr=self.rescale_betas_zero_snr,
            parameterization=self.parameterization,
            use_dynamic_rescale=self.use_dynamic_rescale, base_scale=self.base_scale,
            turning_step=self.turning_step)


def schedule_arrays(sched: S.DiffusionSchedule, device=None) -> dict:
    """Device copies of the schedule fields training reads (mdm.py:96-105)."""
    names = ["sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "lvlb_weights"]
    if sched.scale_arr is not None:
        names.append("scale_arr")
    return {n: torch.as_tensor(getattr(sched, n), device=device) for n in names}


def stage2_config(**overrides) -> MDMConfig:
    """MDM1024 deltas (configs/stage2-1024_mdm_waymo/config.yaml): 576x1024
    video, 72x128 latents, base_scale 0.3; the architecture is unchanged."""
    return MDMConfig(base_scale=0.3, **overrides)


class MDM(nn.Module):
    """All five sub-models; state_dict keys unet.*, vae.*, image_proj.*,
    clip_text.*, clip_image.*, as the tree of `init_mdm` (mdm.py:108-116)."""

    def __init__(self, cfg: MDMConfig):
        super().__init__()
        self.cfg = cfg
        self.unet = U.UNet3D(cfg.unet)
        self.vae = V.AutoencoderKL(cfg.vae)
        self.image_proj = R.Resampler(cfg.resampler)
        self.clip_text = CL.TextTower(cfg.clip_text)
        self.clip_image = CL.VisionTower(cfg.clip_image)


# The UNet's zero-initialised layers (mudg_tpu/nn/unet3d.py:438-530,
# nn/attention.py:684-706): every transformer's proj_out, each res block's
# out_layers.3 and temporal conv4.3, the output conv and the fps
# embedding's last linear
ZERO_INIT = re.compile(r"^unet\.(.*\.proj_out|.*\.out_layers\.3|.*\.conv4\.3|out\.2"
                       r"|fps_embedding\.2)$")
# Parameters drawn from a normal law, as std (or a function of the shape)
# (conditioning/clip.py:141-158, nn/resampler.py:84-88)
NORMAL_INIT = {"token_embedding.weight": 0.02, "positional_embedding": 0.01,
               "class_embedding": 0.02, "latents": lambda shape: shape[-1] ** -0.5}


@torch.no_grad()
def init_mdm(cfg: MDMConfig, generator: torch.Generator, device=None) -> MDM:
    """A randomly initialised MDM in fp32 on `device` (default: the
    generator's), each parameter drawn from `generator` from the law its JAX
    initialiser uses (mudg_tpu/models/mdm.py:108, nn/functional.py:272-309):
    linear and conv weights uniform within sqrt(3 / fan_in) (kaiming
    uniform), their biases within 1 / sqrt(fan_in); ZERO_INIT layers,
    MultiheadAttention's in_proj_bias and the image-attention alpha zero;
    norm scales one and shifts zero; NORMAL_INIT embeddings normal."""
    device = torch.device(generator.device if device is None else device)
    with torch.device("meta"):
        mdm = MDM(cfg)
    mdm.to_empty(device=device)
    kw = dict(generator=generator, device=device)

    def uniform_(p, bound):
        p.copy_(torch.rand(p.shape, **kw).mul_(2 * bound).sub_(bound))

    for mname, mod in mdm.named_modules():
        own = dict(mod.named_parameters(recurse=False))
        for pname, p in own.items():
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                p.fill_(1.0 if pname == "weight" else 0.0)
            elif ZERO_INIT.match(mname) or pname in ("in_proj_bias", "alpha"):
                p.zero_()
            elif any(name.endswith(k) for k in NORMAL_INIT):
                std = next(v for k, v in NORMAL_INIT.items() if name.endswith(k))
                p.copy_(torch.randn(p.shape, **kw) * (std(p.shape) if callable(std) else std))
            elif pname in ("weight", "in_proj_weight"):
                uniform_(p, math.sqrt(3.0 / p[0].numel()))
            elif pname == "bias":
                uniform_(p, 1.0 / math.sqrt(own["weight"][0].numel()))
            else:
                raise ValueError(f"init_mdm: no initialiser for {name}")
    return mdm


def encode_text(mdm: MDM, tokens):
    """tokens (B, 77) -> (B, 77, 1024) (FrozenOpenCLIPEmbedder)."""
    with profiling.span("clip_text"):
        return mdm.clip_text(tokens)


def embed_image(mdm: MDM, images):
    """images (B, H, W, 3) in [-1, 1] -> resampled tokens (B, T*16, 1024)
    (ddpm3d.py:1107-1111: CLIP image embedder + image_proj_model)."""
    with profiling.span("clip_image"):
        feats = mdm.clip_image(images)
    with profiling.span("image_proj"):
        return mdm.image_proj(feats)


def encode_conditions(mdm: MDM, sparse_frames, sparse_depth):
    """VAE-encode the sparse RGB and depth condition videos in one stacked
    call -> c_concat (B, T, h, w, 8) from the posterior modes
    (ddpm3d.py:1078-1079,1122)."""
    x = torch.cat([sparse_frames, sparse_depth])
    z = V.encode_video(mdm.vae, x, chunk=mdm.cfg.vae_chunk)
    sparse_z, depth_z = z.chunk(2)
    return torch.cat([sparse_z, depth_z], dim=-1)


def denoise(unet: U.UNet3D, z_noisy, t, c_concat, context, class_label, fs=None,
            *, impl="auto", remat=False, generator=None, sp=None):
    """DiffusionWrapper 'hybrid' forward (ddpm3d.py:1320-1324): channel-concat
    conditions + cross-attention context + class label."""
    x = torch.cat([z_noisy, c_concat.to(z_noisy.dtype)], dim=-1)
    return unet(x, t, context, c_label=class_label, fs=fs, impl=impl, remat=remat,
                generator=generator, sp=sp)


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def training_shapes(cfg: MDMConfig, batch) -> dict:
    """The shapes of a batch's random draws: "latent" (B, T, h, w, z) of the
    target latents, "posterior" of the posterior samples of every encoded
    video (3B stacked, or B dense frames in interp mode)."""
    zc = cfg.vae.embed_dim
    if "dense_moments" in batch:
        lat = tuple(batch["dense_moments"].shape[:-1]) + (zc,)
    else:
        b, t, hh, ww = batch["dense_frames"].shape[:4]
        f = 2 ** (len(cfg.vae.ch_mult) - 1)
        lat = (b, t, hh // f, ww // f, zc)
    post = lat if cfg.interp_mode else (3 * lat[0],) + lat[1:]
    return {"latent": lat, "posterior": post}


def draw_training_noise(cfg: MDMConfig, shapes: dict, generator: torch.Generator) -> dict:
    """Every random draw of one `training_loss` call, from `generator`, on
    its device: "t" (B,) int64 timesteps, "noise" (latent) the diffusion
    noise, "posterior_eps" (posterior) the VAE posterior sample's normal
    draw, "cfg_uniform" (B,) the CFG-dropout uniform, "offset_noise"
    (B, T, 1, 1, z) the offset noise (used when cfg.noise_strength > 0)."""
    lat = shapes["latent"]
    b = lat[0]
    kw = dict(generator=generator, device=generator.device)
    return {
        "t": torch.randint(0, cfg.timesteps, (b,), **kw),
        "noise": torch.randn(lat, **kw),
        "posterior_eps": torch.randn(shapes["posterior"], **kw),
        "cfg_uniform": torch.rand((b,), **kw),
        "offset_noise": torch.randn((b, lat[1], 1, 1, lat[-1]), **kw),
    }


def _posterior_sample(cfg: MDMConfig, moments, eps):
    """scale_factor * (mean + std * eps) of the posterior (vae.py:148-154)."""
    post = DiagonalGaussian.from_moments(moments)
    return cfg.vae.scale_factor * (post.mean + post.std * eps.to(post.mean.dtype))


def training_loss(mdm: MDM, batch: dict, draws: dict, *, null_emb=None, null_tokens=None,
                  sched_arrays: dict | None = None, impl: str = "train",
                  remat: bool | str = True,
                  compute_dtype=torch.bfloat16, generator: torch.Generator | None = None,
                  sp=None):
    """shared_step / p_losses of the MDM (ddpm3d.py:1056-1149, 741-788;
    mdm.py:163-310). Returns (loss, {"loss_simple", "t_mean"}).

    batch: dense_frames, sparse_frames, sparse_depth (B, T, H, W, 3) in
    [-1, 1], tokens (B, 77) int, class_label (B,) int, optional fps (B,);
    or the moments form: dense_moments, sparse_moments, depth_moments
    (B, T, h, w, 2z) and sparse_frame0 (B, H, W, 3) in place of the videos.
    draws: `draw_training_noise`'s dict. null_emb (1 or B, 77, D): the
    empty prompt's embedding, or null_tokens (77,) to encode it here.
    The frozen VAE and CLIP towers run under no_grad in compute_dtype; the
    resampler (image_proj) and the UNet (remat: False, True or a policy of
    `nn/remat.POLICIES`; dropout from `generator`; sequence-parallel under
    `sp`) carry gradients to their fp32 parameters; the diffusion algebra
    and the loss are fp32."""
    cfg = mdm.cfg
    cdt = compute_dtype
    if sched_arrays is None:
        sched_arrays = schedule_arrays(cfg.schedule(), draws["noise"].device)
    eps = draws["posterior_eps"]
    with torch.no_grad():
        if cfg.interp_mode:
            m = V.encode_moments_video(mdm.vae, batch["dense_frames"].to(cdt),
                                       chunk=cfg.vae_chunk)
            z = _posterior_sample(cfg, m, eps).float()
            # start + end frame conditioning, the depth half zero (ddpm3d.py:1114-1118)
            zc = torch.zeros_like(z)
            zc[:, 0], zc[:, -1] = z[:, 0], z[:, -1]
            c_concat = torch.cat([zc, torch.zeros_like(zc)], dim=-1)
        elif "dense_moments" in batch:
            m3 = torch.cat([batch["dense_moments"], batch["sparse_moments"],
                            batch["depth_moments"]]).float()
            z, sparse_z, depth_z = _posterior_sample(cfg, m3, eps).chunk(3)
            c_concat = torch.cat([sparse_z, depth_z], dim=-1).to(cdt)
        else:
            # one stacked encode of the dense target, sparse RGB and depth
            enc_in = torch.cat([batch["dense_frames"], batch["sparse_frames"],
                                batch["sparse_depth"]]).to(cdt)
            n_frames = enc_in.shape[0] * enc_in.shape[1]
            chunk = cfg.train_encode_chunk
            while chunk > 1 and n_frames % chunk:
                chunk //= 2
            m3 = V.encode_moments_video(mdm.vae, enc_in, chunk=chunk)
            z, sparse_z, depth_z = _posterior_sample(cfg, m3, eps).chunk(3)
            z = z.float()
            c_concat = torch.cat([sparse_z, depth_z], dim=-1)
        b = z.shape[0]
        cond_emb = encode_text(mdm, batch["tokens"])
        if null_emb is None:
            null_emb = encode_text(mdm, null_tokens.expand(b, -1))
        null_emb = null_emb.expand_as(cond_emb).to(cond_emb.dtype)

        # disjoint 5 / 5 / 5 % text / image / both CFG dropout (ddpm3d.py:1091-1099)
        u = draws["cfg_uniform"]
        p = cfg.uncond_prob
        prompt_emb = torch.where((u < 2 * p)[:, None, None], null_emb, cond_emb)
        input_mask = 1.0 - ((u >= p) & (u < 3 * p)).to(z.dtype).reshape(b, 1, 1, 1)
        img_src = batch["sparse_frame0"] if "sparse_frame0" in batch else batch["sparse_frames"][:, 0]
        img_tokens = mdm.clip_image((img_src * input_mask).to(cdt))
    img_emb = mdm.image_proj(img_tokens)           # trainable
    context = torch.cat([prompt_emb.to(cdt), img_emb.to(cdt)], dim=1)

    t = draws["t"]
    if "scale_arr" in sched_arrays:
        z = z * D.extract(sched_arrays["scale_arr"], t, z.ndim)
    noise = draws["noise"]
    if cfg.noise_strength > 0:
        noise = noise + cfg.noise_strength * draws["offset_noise"]
    sa = sched_arrays["sqrt_alphas_cumprod"]
    soma = sched_arrays["sqrt_one_minus_alphas_cumprod"]
    z_noisy = D.q_sample(z, t, noise, sa, soma)
    target = D.get_v(z, noise, t, sa, soma)
    v_pred = denoise(mdm.unet, z_noisy.to(cdt), t, c_concat.to(cdt), context,
                     batch["class_label"], fs=batch.get("fps"), impl=impl, remat=remat,
                     generator=generator, sp=sp).float()
    loss_simple = ((v_pred - target.float()) ** 2).mean(dim=(1, 2, 3, 4))
    loss = cfg.l_simple_weight * loss_simple.mean()
    if cfg.original_elbo_weight > 0:
        loss = loss + cfg.original_elbo_weight * (sched_arrays["lvlb_weights"][t]
                                                  * loss_simple).mean()
    return loss, {"loss_simple": loss_simple.mean().detach(), "t_mean": t.float().mean()}


def _guided_model_fn(mdm, variants, c_concat, class_label, fs, guidance_scale, cfg_img,
                     guidance_rescale, impl, sp=None):
    """model_fn(x, t) -> guided v: one UNet call over the stacked variants
    (uncond [, image-only], full), combined by 2- or 3-point CFG, then
    guidance rescale."""
    n_var = len(variants)
    ctx_all = torch.cat(variants)
    cc_all = c_concat.repeat(n_var, 1, 1, 1, 1)
    label_all = class_label.repeat(n_var)
    fs_all = fs.repeat(n_var)

    def model_fn(x, tt):
        v = denoise(mdm.unet, x.repeat(n_var, 1, 1, 1, 1), tt.repeat(n_var), cc_all,
                    ctx_all, label_all, fs=fs_all, impl=impl, sp=sp)
        parts = v.chunk(n_var)
        if n_var == 3:
            out = D.cfg_combine_multicond(parts[0], parts[1], parts[2], guidance_scale, cfg_img)
        elif n_var == 2:
            out = D.cfg_combine(parts[0], parts[1], guidance_scale)
        else:
            out = parts[0]
        if guidance_rescale > 0.0 and n_var > 1:
            out = D.rescale_noise_cfg(out, parts[-1], guidance_rescale)
        return out

    return model_fn


def _decode(mdm, z, chunk, sp=None):
    x = V.decode_video(mdm.vae, SP.frames(z, sp),
                       chunk=mdm.cfg.vae_chunk if chunk is None else chunk)
    return SP.gather(torch.clamp(x, -1.0, 1.0).float(), 1, sp)


@torch.no_grad()
def sample(mdm: MDM, *, generator: torch.Generator, sparse_frames=None, sparse_depth=None,
           sparse_moments=None, depth_moments=None, frame0=None, tokens=None,
           null_tokens=None, class_label=None, num_steps: int = 50,
           guidance_scale: float = 7.5, cfg_img: float | None = None,
           multiple_cond_cfg: bool = False, guidance_rescale: float = 0.7,
           eta: float = 1.0, timestep_spacing: str = "uniform_trailing",
           fs: int | None = None, decode: bool = True, impl: str = "auto",
           dtype=torch.float32, vae_dtype=None, sampler: str = "ddim", x_T=None, sp=None):
    """image_guided_synthesis (virtual_pose_render.py:62-147; mdm.py:317-455).

    sparse_frames / sparse_depth (B, T, H, W, 3) in [-1, 1] (B = tasks);
    tokens (B, 77) and null_tokens (77,) integer token ids; class_label (B,).
    Or the moments form: sparse_moments / depth_moments (B, T, h, w, 2z)
    posterior moments plus frame0 (B, H, W, 3) pixels for the CLIP image
    branch; c_concat is then the posterior mode, with no VAE encode.
    multiple_cond_cfg adds the image-only variant (3-point CFG); sampler is
    "ddim" or "dpmpp" (DPM-Solver++(2M), deterministic, eta unused).
    vae_dtype (default `dtype`) is the compute dtype of the VAE and CLIP
    encoders and of the decode; the UNet and the sampler run in `dtype`.
    The start noise is x_T or drawn from `generator`, which also draws the
    DDIM step noise. Returns the video (B, T, H, W, 3) in [-1, 1] as float32,
    or the latents when decode is False. sp: sequence-parallel (every rank
    passes the same inputs and generator state and gets the whole clip;
    impl "plain").
    """
    cfg = mdm.cfg
    vdt = dtype if vae_dtype is None else vae_dtype
    use_moments = sparse_moments is not None
    src = sparse_moments if use_moments else sparse_frames
    b, t_frames = src.shape[:2]
    device = src.device
    sched = cfg.schedule()
    if use_moments:
        m2 = torch.cat([sparse_moments, depth_moments]).float()
        sz, dz = V.sample_scaled(cfg.vae, m2).chunk(2)
        c_concat = torch.cat([sz, dz], dim=-1).to(dtype)
    else:
        c_concat = SP.gather(encode_conditions(mdm, SP.frames(sparse_frames.to(vdt), sp),
                                               SP.frames(sparse_depth.to(vdt), sp)),
                             1, sp).to(dtype)

    cond_emb = encode_text(mdm, tokens).to(dtype)
    uc_emb = encode_text(mdm, null_tokens.expand(tokens.shape)).to(dtype)
    img = (frame0 if use_moments else sparse_frames[:, 0]).to(vdt)
    # condition and null image embeds in one stacked CLIP + resampler pass
    img_emb, uc_img_emb = (e.to(dtype) for e in
                           embed_image(mdm, torch.cat([img, torch.zeros_like(img)])).chunk(2))
    variants = [torch.cat([uc_emb, uc_img_emb], dim=1)]
    if multiple_cond_cfg:
        variants.append(torch.cat([uc_emb, img_emb], dim=1))
    variants.append(torch.cat([cond_emb, img_emb], dim=1))
    fs_arr = torch.full((b,), cfg.default_fs if fs is None else fs, device=device,
                        dtype=torch.int64)
    model_fn = _guided_model_fn(mdm, variants, c_concat, class_label, fs_arr,
                                guidance_scale, cfg_img, guidance_rescale, impl, sp)

    shape = (b, t_frames, *c_concat.shape[2:4], cfg.unet.out_channels)
    if sampler == "dpmpp":
        consts = dpm.make_dpmpp_constants(sched, num_steps,
                                          timestep_spacing=timestep_spacing, device=device)
        z = dpm.dpmpp_sample(model_fn, generator, shape, consts, x_T=x_T, dtype=dtype,
                             device=device)
    elif sampler == "ddim":
        consts = ddim.make_ddim_constants(sched, num_steps, timestep_spacing=timestep_spacing,
                                          eta=eta, device=device)
        z = ddim.ddim_sample(model_fn, generator, shape, consts, x_T=x_T, dtype=dtype,
                             device=device)
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    if not decode:
        return z
    return _decode(mdm, z.to(vdt), None, sp)


@torch.no_grad()
def sample_clip(mdm: MDM, c_concat, ctx_cond, ctx_uncond, class_label, *,
                generator: torch.Generator, ctx_uncond_img=None, num_steps: int = 25,
                guidance_scale: float = 7.5, cfg_img: float | None = None,
                guidance_rescale: float = 0.7, eta: float = 1.0,
                timestep_spacing: str = "uniform_trailing", fs: int | None = None,
                x_T=None, decode: bool = True, decode_chunk: int | None = None,
                impl: str = "auto"):
    """Guided DDIM + decode with the conditioning given (mdm.py:415-455).

    c_concat (B, T, h, w, 8) conditions; ctx_cond / ctx_uncond (B, L, D)
    full and unconditional contexts; ctx_uncond_img (optional) the
    image-only context, which turns on 3-point CFG; class_label (B,).
    Computes in c_concat's dtype. Returns the video (B, T, 8h, 8w, 3) in
    [-1, 1] as float32, or the latents when decode is False.
    """
    cfg = mdm.cfg
    dtype, device = c_concat.dtype, c_concat.device
    b, t, h, w = c_concat.shape[:4]
    consts = ddim.make_ddim_constants(cfg.schedule(), num_steps,
                                      timestep_spacing=timestep_spacing, eta=eta,
                                      device=device)
    variants = [ctx_uncond] + ([ctx_uncond_img] if ctx_uncond_img is not None else []) + [ctx_cond]
    fs_arr = torch.full((b,), cfg.default_fs if fs is None else fs, device=device,
                        dtype=torch.int64)
    model_fn = _guided_model_fn(mdm, [c.to(dtype) for c in variants], c_concat, class_label,
                                fs_arr, guidance_scale, cfg_img, guidance_rescale, impl)
    z = ddim.ddim_sample(model_fn, generator, (b, t, h, w, cfg.unet.out_channels), consts,
                         x_T=x_T, dtype=dtype, device=device)
    if not decode:
        return z
    return _decode(mdm, z, decode_chunk)
