"""The MDM (multi-modal diffusion model): conditioning assembly and guided
sampling.

Port of the inference half of `mudg_tpu/models/mdm.py` (reference
LatentVisualDiffusion, `lvdm/models/ddpm3d.py:1033-1300`, and the condition
assembly of `virtual_render/virtual_pose_render.py:62-147`). Videos are
(B, T, H, W, 3) channels-last in [-1, 1], latents (B, T, h, w, 4);
  c_concat    = cat(sparse_rgb_z, sparse_depth_z) over channels (B, T, h, w, 8)
  c_crossattn = cat(text_emb (B, 77, 1024), img_emb (B, T*16, 1024))
CFG variants are stacked on the batch axis, so each sampler step is one UNet
call at batch n_variants*B. `sample` is the whole path from pixels and token
ids to the clip; `sample_clip` is its second half with the context given.
The sequence-parallel path (`sp`) waits for the multi-GPU slice.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..conditioning import clip as CL
from ..core import diffusion as D
from ..core import schedules as S
from ..diffusion import ddim, dpm
from ..nn import resampler as R
from ..nn import unet3d as U
from ..nn import vae as V


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

    def schedule(self) -> S.DiffusionSchedule:
        return S.DiffusionSchedule.create(
            timesteps=self.timesteps, beta_schedule=self.beta_schedule,
            linear_start=self.linear_start, linear_end=self.linear_end,
            rescale_betas_zero_snr=self.rescale_betas_zero_snr,
            parameterization=self.parameterization,
            use_dynamic_rescale=self.use_dynamic_rescale, base_scale=self.base_scale,
            turning_step=self.turning_step)


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


def encode_text(mdm: MDM, tokens):
    """tokens (B, 77) -> (B, 77, 1024) (FrozenOpenCLIPEmbedder)."""
    return mdm.clip_text(tokens)


def embed_image(mdm: MDM, images):
    """images (B, H, W, 3) in [-1, 1] -> resampled tokens (B, T*16, 1024)
    (ddpm3d.py:1107-1111: CLIP image embedder + image_proj_model)."""
    return mdm.image_proj(mdm.clip_image(images))


def encode_conditions(mdm: MDM, sparse_frames, sparse_depth):
    """VAE-encode the sparse RGB and depth condition videos in one stacked
    call -> c_concat (B, T, h, w, 8) from the posterior modes
    (ddpm3d.py:1078-1079,1122)."""
    x = torch.cat([sparse_frames, sparse_depth])
    z = V.encode_video(mdm.vae, x, chunk=mdm.cfg.vae_chunk)
    sparse_z, depth_z = z.chunk(2)
    return torch.cat([sparse_z, depth_z], dim=-1)


def denoise(unet: U.UNet3D, z_noisy, t, c_concat, context, class_label, fs=None,
            *, impl="auto"):
    """DiffusionWrapper 'hybrid' forward (ddpm3d.py:1320-1324): channel-concat
    conditions + cross-attention context + class label."""
    x = torch.cat([z_noisy, c_concat.to(z_noisy.dtype)], dim=-1)
    return unet(x, t, context, c_label=class_label, fs=fs, impl=impl)


def _guided_model_fn(mdm, variants, c_concat, class_label, fs, guidance_scale, cfg_img,
                     guidance_rescale, impl):
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
                    ctx_all, label_all, fs=fs_all, impl=impl)
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


def _decode(mdm, z, chunk):
    x = V.decode_video(mdm.vae, z, chunk=mdm.cfg.vae_chunk if chunk is None else chunk)
    return torch.clamp(x, -1.0, 1.0).float()


@torch.no_grad()
def sample(mdm: MDM, *, generator: torch.Generator, sparse_frames=None, sparse_depth=None,
           sparse_moments=None, depth_moments=None, frame0=None, tokens=None,
           null_tokens=None, class_label=None, num_steps: int = 50,
           guidance_scale: float = 7.5, cfg_img: float | None = None,
           multiple_cond_cfg: bool = False, guidance_rescale: float = 0.7,
           eta: float = 1.0, timestep_spacing: str = "uniform_trailing",
           fs: int | None = None, decode: bool = True, impl: str = "auto",
           dtype=torch.float32, vae_dtype=None, sampler: str = "ddim", x_T=None):
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
    or the latents when decode is False.
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
        c_concat = encode_conditions(mdm, sparse_frames.to(vdt),
                                     sparse_depth.to(vdt)).to(dtype)

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
                                guidance_scale, cfg_img, guidance_rescale, impl)

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
    return _decode(mdm, z.to(vdt), None)


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
