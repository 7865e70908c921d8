"""DepthLab: diffusion depth inpainting (the learned depth densification).

Port of `mudg_tpu/models/depthlab.py` (reference
`data_process/depthlab_tools.py:446-490`): a Marigold (SD2-based) latent
diffusion stack with two `UNet2DConditionModel`s (`models/sd_unet2d.py`), a
`reference_unet` (in_channels=4) that encodes the RGB latent once and a
`denoising_unet` (in_channels=12) that denoises the depth latent while
reading the reference UNet's self-attention states, plus the `mapping_layer`
(`My_proj`, depthlab_tools.py:461-466) that projects a CLIP image embedding
into the cross-attention context. The wiring is JAX's:
  * denoising UNet input (12ch) = [noisy depth latent (4) | known depth
    latent (4) | latent-resolution known mask broadcast to 4],
  * the reference UNet runs once at t=0; its bank serves every step,
  * context = mapping_layer(CLIP image_embeds) as one token, or zeros,
  * prediction_type "eps" (default) or "v".

Weights: `denoising_unet.pth` / `reference_unet.pth` / `mapping_layer.pth`
(diffusers naming) load into the modules as they are; the Marigold VAE
(diffusers AutoencoderKL naming) is renamed into the CompVis layout of
`nn/vae.AutoencoderKL` (`diffusers_vae_state_dict`). Noise comes from a
`torch.Generator` (seeded 0 per call by default); the start noise and each
step's blend noise can be given instead (`noise`).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from ..core import schedules as S
from ..core.distributions import DiagonalGaussian
from ..diffusion.ddim import make_ddim_constants
from ..kernels import prepare_kernels
from ..nn import functional as F
from ..nn import vae as VAE
from . import sd_unet2d


@dataclasses.dataclass(frozen=True)
class DepthLabConfig:
    unet: sd_unet2d.SDUNetConfig = dataclasses.field(
        default_factory=lambda: sd_unet2d.SDUNetConfig(in_channels=12))
    ref_unet: sd_unet2d.SDUNetConfig = dataclasses.field(
        default_factory=lambda: sd_unet2d.SDUNetConfig(in_channels=4))
    vae: VAE.VAEConfig = dataclasses.field(default_factory=VAE.VAEConfig)
    image_embed_dim: int = 1024       # CLIPVisionModelWithProjection (ViT-H)
    prediction_type: str = "eps"      # scheduler prediction_type
    num_train_timesteps: int = 1000
    linear_start: float = 0.00085     # SD "scaled_linear" betas
    linear_end: float = 0.012
    scale_factor: float = 0.18215


def make_schedule(cfg: DepthLabConfig) -> S.DiffusionSchedule:
    """The plain SD2 schedule: no zero-terminal-SNR rescale, no dynamic
    rescale; "linear" is lvdm/diffusers "scaled_linear"."""
    return S.DiffusionSchedule.create(
        timesteps=cfg.num_train_timesteps, beta_schedule="linear",
        linear_start=cfg.linear_start, linear_end=cfg.linear_end,
        rescale_betas_zero_snr=False, parameterization=cfg.prediction_type,
        use_dynamic_rescale=False)


def ddim_constants(sched, steps, device=None):
    """Trailing spacing, eta 0 (exact for any step count)."""
    return make_ddim_constants(sched, steps, timestep_spacing="uniform_trailing", eta=0.0,
                               device=device)


class DepthLab(nn.Module):
    """The two UNets and the mapping layer; `state_dict()` keys are JAX's
    tree paths (denoising_unet.*, reference_unet.*, mapping_layer.*)."""

    def __init__(self, cfg: DepthLabConfig = DepthLabConfig()):
        super().__init__()
        self.cfg = cfg
        self.denoising_unet = sd_unet2d.UNet2DConditionModel(cfg.unet)
        self.reference_unet = sd_unet2d.UNet2DConditionModel(cfg.ref_unet)
        self.mapping_layer = nn.Linear(cfg.image_embed_dim, cfg.unet.cross_attention_dim)


def mapping_apply(m, image_embeds):
    """`My_proj` (depthlab_tools.py:461-466): the CLIP image embedding
    projected into the UNet's cross-attention space, one token per image."""
    return F.linear(m, image_embeds)[:, None, :]


# ---------------------------------------------------------------------------
# Diffusers-format VAE import (Marigold ships an SD2 AutoencoderKL)
# ---------------------------------------------------------------------------

def _rename_diffusers_vae_key(key: str, num_levels: int = 4) -> str:
    """diffusers AutoencoderKL state_dict key -> CompVis (nn/vae.py) key."""
    k = key
    k = k.replace("conv_norm_out", "norm_out")
    k = k.replace("mid_block.resnets.0", "mid.block_1")
    k = k.replace("mid_block.resnets.1", "mid.block_2")
    k = k.replace("mid_block.attentions.0", "mid.attn_1")
    k = k.replace(".group_norm.", ".norm.")
    k = k.replace(".to_q.", ".q.").replace(".to_k.", ".k.").replace(".to_v.", ".v.")
    k = k.replace(".to_out.0.", ".proj_out.")
    k = k.replace(".conv_shortcut.", ".nin_shortcut.")
    if ".down_blocks." in k:
        k = k.replace(".down_blocks.", ".down.").replace(".resnets.", ".block.")
        k = k.replace(".downsamplers.0.conv.", ".downsample.conv.")
    if ".up_blocks." in k:
        # diffusers decoder up_blocks run coarse -> fine; CompVis indexes
        # fine -> coarse and iterates reversed (ae_modules.py Decoder)
        parts = k.split(".")
        i = parts.index("up_blocks")
        parts[i] = "up"
        parts[i + 1] = str(num_levels - 1 - int(parts[i + 1]))
        k = ".".join(parts).replace(".resnets.", ".block.")
        k = k.replace(".upsamplers.0.conv.", ".upsample.conv.")
    return k


def diffusers_vae_state_dict(sd, num_levels: int = 4) -> dict[str, torch.Tensor]:
    """Flat diffusers AutoencoderKL state dict -> `nn/vae.AutoencoderKL`'s,
    float32 tensors. The attention's q/k/v/out projections are Linear in
    diffusers and 1x1 convs in the CompVis layout: (out, in) -> (out, in, 1, 1)."""
    out = {}
    for key, val in sd.items():
        val = np.asarray(val, np.float32)
        new = _rename_diffusers_vae_key(key, num_levels)
        if ".attn_1." in new and new.endswith(".weight") and val.ndim == 2:
            val = val.reshape(*val.shape, 1, 1)
        out[new] = torch.from_numpy(np.ascontiguousarray(val))
    return out


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _ddim_depth_loop(model: DepthLab, cfg: DepthLabConfig, sched, z_rgb, z_depth, mask_lat,
                     context, generator, *, steps: int, strength: float, blend: bool,
                     noise=None):
    """The reference pass once, then DDIM over the last
    n_run = max(1, min(steps, round(steps * strength))) of `steps` trailing
    steps from a noised copy of the known depth latent, re-imposing the known
    region at each step's noise level (latent blending). z_rgb/z_depth:
    (B, h, w, 4) scaled latents; mask_lat (B, h, w, 1), 1 where depth is
    known. `noise`: (start noise, [each step's blend noise]) in place of
    draws from `generator`. The update algebra runs in fp32. Returns the
    final depth latent (B, h, w, 4) in z_depth's dtype."""
    b = z_rgb.shape[0]
    dev = z_depth.device
    consts = ddim_constants(sched, steps, device=dev)
    n_run = max(1, min(steps, int(round(steps * strength))))

    def draw():
        return torch.randn(z_depth.shape, generator=generator, device=dev, dtype=z_depth.dtype)

    _, bank = model.reference_unet(z_rgb, torch.zeros(b, dtype=torch.int64, device=dev),
                                   context, ref_mode="write")
    bank = [h.to(z_rgb.dtype) for h in bank]

    mask4 = mask_lat.expand(z_depth.shape).to(z_depth.dtype)
    start = steps - n_run
    noise0 = noise[0].to(dev, z_depth.dtype) if noise is not None else draw()
    a0 = consts.alphas[start]
    x = (torch.sqrt(a0) * z_depth.float() + torch.sqrt(1.0 - a0) * noise0.float()).to(z_depth.dtype)

    sqrt_ac = torch.as_tensor(sched.sqrt_alphas_cumprod, device=dev)
    sqrt_omac = torch.as_tensor(sched.sqrt_one_minus_alphas_cumprod, device=dev)
    for i in range(start, steps):
        ts = consts.ts[i]
        if blend:
            nq = noise[1][i - start].to(dev, z_depth.dtype) if noise is not None else draw()
            x_known = sqrt_ac[ts] * z_depth.float() + sqrt_omac[ts] * nq.float()
            x = (mask4 * x_known + (1.0 - mask4) * x.float()).to(z_depth.dtype)
        inp = torch.cat([x, z_depth, mask4], dim=-1)
        out = model.denoising_unet(inp, ts.expand(b), context, ref_mode="read", ref_bank=bank)
        xf, of = x.float(), out.float()
        a_t, a_prev = consts.alphas[i], consts.alphas_prev[i]
        if cfg.prediction_type == "v":
            e_t = torch.sqrt(a_t) * of + torch.sqrt(1 - a_t) * xf
            x0 = torch.sqrt(a_t) * xf - torch.sqrt(1 - a_t) * of
        else:
            e_t = of
            x0 = (xf - torch.sqrt(1.0 - a_t) * e_t) / torch.sqrt(a_t)
        x_prev = torch.sqrt(a_prev) * x0 + torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * e_t
        x = x_prev.to(z_depth.dtype)
    if blend:
        x = mask4 * z_depth + (1.0 - mask4) * x
    return x


def prepare_inputs(cfg: DepthLabConfig, image, sparse_depth):
    """The host half of predict_depth: the image in [-1, 1], the classically
    filled depth normalized to [-1, 1] by the lidar's 2nd and 98th
    percentiles (get_filled_for_latents, depthlab_tools.py:322-324), the
    latent-resolution known mask (a latent pixel is known when any pixel of
    its f x f footprint carries lidar) and (lo, hi)."""
    from ..data.depth_tools import densify_classical

    h, w = sparse_depth.shape
    f = 2 ** (len(cfg.vae.ch_mult) - 1)   # the VAE's spatial stride
    assert h % f == 0 and w % f == 0, (h, w, f)
    img = np.asarray(image, np.float32)
    if img.max() > 2.0:
        img = img / 255.0
    img = img * 2.0 - 1.0
    known = (np.asarray(sparse_depth) > 0).astype(np.float32)
    filled = densify_classical(np.asarray(sparse_depth, np.float32))
    valid = np.asarray(sparse_depth)[known > 0]
    if valid.size >= 2:
        lo, hi = np.percentile(valid, 2.0), np.percentile(valid, 98.0)
    else:
        lo, hi = 0.0, 1.0
    hi = max(hi, lo + 1e-6)
    dn = np.clip((filled - lo) / (hi - lo), 0.0, 1.0) * 2.0 - 1.0
    mask_lat = known.reshape(h // f, f, w // f, f).max(axis=(1, 3))
    return img, np.repeat(dn[..., None], 3, axis=-1), mask_lat, (lo, hi)


@torch.no_grad()
def predict_depth(model: DepthLab, cfg: DepthLabConfig, vae: VAE.AutoencoderKL, image,
                  sparse_depth, *, generator=None, steps: int = 50, strength: float = 0.8,
                  blend: bool = True, context=None, dtype=torch.float32, noise=None):
    """generate_depth_map (depthlab_tools.py:317-344). image: (H, W, 3) in
    [0, 255] or [0, 1]; sparse_depth: (H, W) metric with 0 at holes; H and W
    multiples of 8. Runs on the device of `model`, whose weights (and
    `vae`'s) must be in `dtype`. `context`: the mapped CLIP image embedding
    (B, 1, ctx), or None for a zero context. Returns the relative depth
    rescaled to the lidar's [lo, hi] (metric alignment is
    `data/depth_tools.align_depth`, as in the reference pipeline)."""
    dev = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    img, dep3, mask_lat, (lo, hi) = prepare_inputs(cfg, image, sparse_depth)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dtype)[None]

    sched = make_schedule(cfg)
    z_rgb = DiagonalGaussian.from_moments(vae.encode_moments(put(img))).mode() * cfg.scale_factor
    z_dep = DiagonalGaussian.from_moments(vae.encode_moments(put(dep3))).mode() * cfg.scale_factor
    if context is None:
        context = torch.zeros(1, 1, cfg.unet.cross_attention_dim, device=dev, dtype=dtype)
    z = _ddim_depth_loop(model, cfg, sched, z_rgb.to(dtype), z_dep.to(dtype),
                         put(mask_lat)[..., None], context, generator, steps=steps,
                         strength=strength, blend=blend, noise=noise)
    # JAX's decode(z / scale_factor), whose decode divides by it once more
    dec = vae.decode(z / cfg.scale_factor)
    rel = (dec[0].float().mean(dim=-1) + 1.0) / 2.0   # eval_tools-style mean
    rel = torch.clamp(rel, 0.0, 1.0).cpu().numpy().astype(np.float32)
    return rel * (hi - lo) + lo


def _find_linear(sd):
    """The projection Linear inside a `My_proj` state dict, found as JAX
    finds it in the tree (depthlab.py:232-244): at each level a 2-D
    'weight' first, then the children in order. Returns its prefix."""
    tree: dict = {}
    for k in sd:
        node = tree
        for part in k.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[k.split(".")[-1]] = sd[k]

    def walk(node, path):
        w = node.get("weight")
        if w is not None and getattr(w, "ndim", 0) == 2:
            return path
        for name, v in node.items():
            if isinstance(v, dict):
                found = walk(v, path + [name])
                if found is not None:
                    return found
        return None

    path = walk(tree, [])
    return None if path is None else "".join(p + "." for p in path)


def load_depthlab_dir(root: str, cfg: DepthLabConfig | None = None, dtype=None,
                      device="cuda"):
    """Assemble DepthLab from a checkpoint directory laid out as the
    reference expects (depthlab_tools.py:467-476 + Marigold's pretrained
    dir):
        denoising_unet.pth / reference_unet.pth / mapping_layer.pth
        vae/diffusion_pytorch_model.{safetensors|bin}
    on `device` (the card unless the caller asks for the CPU), cast to
    `dtype` when given, kernel weights packed. Returns (model, cfg, vae),
    vae None when the directory holds none."""
    from ..train.checkpoint import load_torch_state_dict

    cfg = cfg or DepthLabConfig()

    def d(*p):
        return os.path.join(root, *p)

    def tensors(sd, prefix=""):
        return {k[len(prefix):]: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                for k, v in sd.items() if k.startswith(prefix)}

    with torch.device("meta"):
        model = DepthLab(cfg)
        vae = VAE.AutoencoderKL(cfg.vae)
    model.to_empty(device=device)
    for name in ("denoising_unet", "reference_unet"):
        getattr(model, name).load_state_dict(
            tensors(load_torch_state_dict(d(f"{name}.pth"))), strict=True)
    mp = load_torch_state_dict(d("mapping_layer.pth"))
    pfx = _find_linear(mp)
    sub = tensors(mp, pfx if pfx is not None else "")
    model.mapping_layer.load_state_dict({k: sub[k] for k in ("weight", "bias")}, strict=True)
    vae_model = None
    for cand in ("vae/diffusion_pytorch_model.safetensors", "vae/diffusion_pytorch_model.bin"):
        if os.path.exists(d(cand)):
            vae.to_empty(device=device)
            vae.load_state_dict(diffusers_vae_state_dict(
                load_torch_state_dict(d(cand)), num_levels=len(cfg.vae.ch_mult)), strict=True)
            vae_model = vae.eval()
            break
    if dtype is not None:
        model.to(dtype)
        if vae_model is not None:
            vae_model.to(dtype)
    prepare_kernels(model)
    return model.eval(), cfg, vae_model


class DepthLabPredictor:
    """`densify_depth_map(..., predictor=...)` adapter holding the models:
    predictor(sparse, image) -> the relative depth that
    `data/depth_tools.densify_depth_map` aligns and sky-fills
    (depthlab_tools.py:317-344, 480-549). The models are cast to `dtype` and
    their kernel weights packed once."""

    def __init__(self, model: DepthLab, cfg: DepthLabConfig, vae, *, steps=50, strength=0.8,
                 blend=True, dtype=torch.float32):
        self.model, self.cfg, self.vae = model.to(dtype), cfg, vae.to(dtype)
        prepare_kernels(self.model)
        self.steps, self.strength, self.blend = steps, strength, blend
        self.dtype = dtype

    def __call__(self, sparse, image=None):
        if image is None:
            image = np.zeros((*sparse.shape, 3), np.float32)
        return predict_depth(self.model, self.cfg, self.vae, image, sparse, steps=self.steps,
                             strength=self.strength, blend=self.blend, dtype=self.dtype)
