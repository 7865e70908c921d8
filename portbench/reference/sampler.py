"""The plain reference of MuDG's guided DDIM sampler.

The diffusion schedule (linear betas, zero terminal SNR, v-prediction, the
dynamic latent rescale of DynamiCrafter), DDIM's per-step constants over
`uniform_trailing` timesteps, classifier-free guidance with the guidance
rescale of arXiv 2305.08891, and one DDIM update. float64 on the host for
the schedule, float32 on the device for the update. Imports nothing of the
program under test.
"""
from __future__ import annotations

import numpy as np
import torch


def schedule(cfg: dict) -> dict:
    """Per-DDPM-timestep alphas_cumprod and the dynamic rescale of a
    configuration (lvdm ddpm3d.py:123-186, 522-527), float64."""
    n = cfg["timesteps"]
    betas = np.linspace(cfg["linear_start"] ** 0.5, cfg["linear_end"] ** 0.5, n,
                        dtype=np.float64) ** 2
    if cfg["rescale_betas_zero_snr"]:
        s = np.sqrt(np.cumprod(1.0 - betas))
        s0, st = s[0], s[-1]
        s = (s - st) * s0 / (s0 - st)
        abar = s ** 2
        betas = 1.0 - np.concatenate([abar[:1], abar[1:] / abar[:-1]])
    ac = np.cumprod(1.0 - betas)
    if cfg["use_dynamic_rescale"]:
        ts = cfg["turning_step"]
        scale = np.concatenate([np.linspace(1.0, cfg["base_scale"], ts),
                                np.full(n, cfg["base_scale"])])[:n]
    else:
        scale = np.ones(n)
    return {"alphas_cumprod": ac.astype(np.float32).astype(np.float64),
            "scale": scale.astype(np.float32).astype(np.float64)}


def ddim_constants(cfg: dict, steps: int, eta: float) -> list[dict]:
    """DDIM's constants per step in sampling order (highest timestep first):
    t, a_t, a_prev, sigma and the rescale ratio scale_prev / scale of the
    x0 prediction, over `uniform_trailing` timesteps."""
    sch = schedule(cfg)
    n = cfg["timesteps"]
    c = n / steps
    ts = np.flip(np.round(np.arange(n, 0, -c))).astype(np.int64) - 1
    ac = sch["alphas_cumprod"]
    a = ac[ts]
    a_prev = np.asarray([ac[0]] + ac[ts[:-1]].tolist())
    sigma = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
    scale = sch["scale"][ts]
    scale_prev = np.concatenate([scale[:1], scale[:-1]])
    out = [dict(t=int(ts[i]), a=a[i], a_prev=a_prev[i], sigma=sigma[i],
                ratio=scale_prev[i] / scale[i]) for i in range(steps)]
    return out[::-1]


def guide(parts, scale: float, cfg_img, rescale: float):
    """Classifier-free guidance over the stacked predictions `parts`
    (uncond, [image-only,] cond): 2-point, or 3-point with the image-only
    prediction (cfg_img, default scale); then the guidance rescale towards
    the conditional prediction's standard deviation (population std over
    every axis of a sample)."""
    if len(parts) == 3:
        u, ui, c = parts
        g = u + (scale if cfg_img is None else cfg_img) * (ui - u) + scale * (c - ui)
    else:
        u, c = parts
        g = u + scale * (c - u)
    if rescale > 0:
        r = g * (c.std(correction=0) / g.std(correction=0).clamp_min(1e-12))
        g = rescale * r + (1 - rescale) * g
    return g


def ddim_update(x, v, const: dict, noise):
    """One DDIM step of a v-prediction model: x_t, v -> x_prev (float32)."""
    x, v = x.float(), v.float()
    a, a_prev, sigma = const["a"], const["a_prev"], const["sigma"]
    eps = np.sqrt(a) * v + np.sqrt(1 - a) * x
    x0 = (np.sqrt(a) * x - np.sqrt(1 - a) * v) * const["ratio"]
    dir_xt = np.sqrt(max(1.0 - a_prev - sigma ** 2, 0.0)) * eps
    return np.sqrt(a_prev) * x0 + dir_xt + sigma * noise.float()


def draws(generator: torch.Generator, shape, steps: int, dtype):
    """The sampler's draws from `generator` in its order: the start noise,
    then each step's noise; returns (x_T, [noise per step])."""
    kw = dict(generator=generator, device=generator.device, dtype=dtype)
    x_t = torch.randn(shape, **kw)
    return x_t, [torch.randn(shape, **kw) for _ in range(steps)]
