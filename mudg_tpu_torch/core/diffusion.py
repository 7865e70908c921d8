"""Diffusion algebra for training (q-sampling, the v target) and the
classifier-free guidance combiners and guidance rescale.

Port of `mudg_tpu/core/diffusion.py` (reference `lvdm/models/ddpm3d.py:
305-314`, `lvdm/models/utils_diffusion.py:147-158`,
`lvdm/models/samplers/ddim_multiplecond.py:220-236`).
"""
from __future__ import annotations

import torch


def extract(a, t, ndim: int):
    """a[t] per batch element, shaped to broadcast over `ndim` dims
    (lvdm/common.py:25-29)."""
    out = a[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def q_sample(x_start, t, noise, sqrt_ac, sqrt_omac):
    """Forward diffusion q(x_t | x_0) (ddpm3d.py:305-308)."""
    nd = x_start.ndim
    return extract(sqrt_ac, t, nd) * x_start + extract(sqrt_omac, t, nd) * noise


def get_v(x, noise, t, sqrt_ac, sqrt_omac):
    """The v-parameterization target (ddpm3d.py:310-314)."""
    nd = x.ndim
    return extract(sqrt_ac, t, nd) * noise - extract(sqrt_omac, t, nd) * x


def cfg_combine(e_uncond, e_cond, guidance_scale):
    """2-point classifier-free guidance; lvdm/models/samplers/ddim.py:226."""
    return e_uncond + guidance_scale * (e_cond - e_uncond)


def cfg_combine_multicond(e_uncond, e_uncond_img, e_cond, guidance_scale, cfg_img=None):
    """3-point CFG over (uncond, image-only, full):
    e_uc + cfg_img * (e_uc_img - e_uc) + s * (e_c - e_uc_img)."""
    if cfg_img is None:
        cfg_img = guidance_scale
    return (e_uncond + cfg_img * (e_uncond_img - e_uncond)
            + guidance_scale * (e_cond - e_uncond_img))


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale=0.0):
    """Guidance rescale (arXiv 2305.08891 §3.4): pull the guided prediction
    toward the conditional branch's std. Population std (correction=0), as
    jnp.std; the 1e-12 floor guards an all-zero prediction."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = torch.std(noise_pred_text, dim=dims, keepdim=True, correction=0)
    std_cfg = torch.std(noise_cfg, dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / torch.clamp(std_cfg, min=1e-12))
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg
