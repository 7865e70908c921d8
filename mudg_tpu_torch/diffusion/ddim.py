"""DDIM sampling for a v-parameterized denoiser.

Port of `mudg_tpu/diffusion/ddim.py` (reference `lvdm/models/samplers/
ddim.py`): the per-step constants are gathered on the host into arrays in
sampling order (high t first), and the loop calls the denoiser once per
step. Classifier-free guidance is composed inside the caller's `model_fn`.
Noise comes from an explicit `torch.Generator`. Beside `ddim_sample`
(optionally blending x against a masked x0 at every step): DDIM's
`stochastic_encode` and the full ancestral `ddpm_sample`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import schedules as S


class DDIMConstants(NamedTuple):
    """Per-step constants in sampling order (index 0 = highest timestep)."""
    ts: torch.Tensor             # (S,) int64 DDPM timesteps
    alphas: torch.Tensor         # (S,) a_t, float32
    alphas_prev: torch.Tensor
    sqrt_one_minus: torch.Tensor
    sigmas: torch.Tensor
    scale: torch.Tensor          # dynamic rescale at t (ones if disabled)
    scale_prev: torch.Tensor


def make_ddim_constants(sched: S.DiffusionSchedule, num_steps: int, *,
                        timestep_spacing: str = "uniform_trailing", eta: float = 1.0,
                        device=None) -> DDIMConstants:
    """DDIMSampler.make_schedule (ddim.py:24-57) as data."""
    steps = S.make_ddim_timesteps(timestep_spacing, num_steps, sched.num_timesteps)
    ac = np.asarray(sched.alphas_cumprod, dtype=np.float64)
    sigmas, alphas, alphas_prev = S.make_ddim_sampling_parameters(ac, steps, eta)
    if sched.scale_arr is not None:
        scale = sched.scale_arr[steps]
        scale_prev = np.concatenate([scale[0:1], scale[:-1]])
    else:
        scale = np.ones_like(alphas)
        scale_prev = np.ones_like(alphas)

    def rev(x, dtype=torch.float32):
        # sampling order: high t -> low t (np.flip at ddim.py:159)
        return torch.as_tensor(x[::-1].copy(), dtype=dtype, device=device)

    return DDIMConstants(ts=rev(steps, torch.int64), alphas=rev(alphas),
                         alphas_prev=rev(alphas_prev),
                         sqrt_one_minus=rev(np.sqrt(1.0 - alphas)), sigmas=rev(sigmas),
                         scale=rev(scale), scale_prev=rev(scale_prev))


def ddim_step(x, v, const: DDIMConstants, noise, *, temperature=1.0):
    """One p_sample_ddim update (ddim.py:231-279): v -> (eps, x0), dynamic
    rescale of x0 by scale_prev/scale, DDIM update. const holds this step's
    fields as 0-d or (B,) tensors. The algebra runs in fp32; returns
    (x_prev, pred_x0) in x's dtype."""
    nd = (1,) * (x.ndim - 1)

    def col(a):
        return torch.as_tensor(a, dtype=torch.float32, device=x.device).reshape(-1, *nd)

    xf, vf = x.float(), v.float()
    a_t, a_prev = col(const.alphas), col(const.alphas_prev)
    soma, sigma = col(const.sqrt_one_minus), col(const.sigmas)
    sa = torch.sqrt(a_t)
    e_t = sa * vf + soma * xf
    pred_x0 = (sa * xf - soma * vf) * (col(const.scale_prev) / col(const.scale))
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * e_t
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise.float() * temperature
    return x_prev.to(x.dtype), pred_x0.to(x.dtype)


def masked_blend(x, mask, x0, sched_t, noise_q):
    """The latent mask blend of the masked loops (ddim.py:174-180, clean_cond
    False): x0 q-sampled to this step's timestep with noise_q, kept where
    mask is 1, x elsewhere. sched_t: (sqrt(ac_t), sqrt(1 - ac_t))."""
    nd = (1,) * (x.ndim - 1)
    sa, soma = (torch.as_tensor(a, device=x.device).reshape(-1, *nd) for a in sched_t)
    img_orig = sa * x0 + soma * noise_q
    return img_orig * mask + (1.0 - mask) * x


def sched_tables(sched: S.DiffusionSchedule, device):
    """(sqrt_alphas_cumprod, sqrt_one_minus_alphas_cumprod) as float32
    tensors on `device`, indexed by DDPM timestep."""
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (sched.sqrt_alphas_cumprod, sched.sqrt_one_minus_alphas_cumprod))


def ddim_sample(model_fn: Callable, generator: torch.Generator, shape, consts: DDIMConstants,
                *, x_T=None, temperature: float = 1.0, mask=None, x0=None,
                sched: S.DiffusionSchedule | None = None, dtype=torch.float32, device=None,
                draws=None):
    """DDIM loop (ddim.py:134-203). model_fn(x, t) -> v with guidance applied,
    t (B,). The start noise is x_T, or drawn from `generator`. With `mask`
    (and x0, sched) each step first blends x against x0 q-sampled to its
    timestep (`masked_blend`, ddim.py:121-136). The generator's order, per
    step: the blend's noise (with a mask), then, after the model call, the
    step's noise. draws: {"noise": (S, *shape)[, "noise_q": (S, *shape)]}
    used in place of the generator's per-step draws (the parity tests pass
    JAX's). Returns the final x."""
    device = device if device is not None else consts.alphas.device
    b = shape[0]
    x = (torch.randn(shape, generator=generator, device=device, dtype=dtype)
         if x_T is None else x_T.to(device=device, dtype=dtype))
    if mask is not None:
        if x0 is None or sched is None:
            raise ValueError("a mask needs x0 and sched")
        sa, soma = sched_tables(sched, device)

    def randn(kind, i):
        if draws is not None:
            return draws[kind][i].to(device=device, dtype=dtype)
        return torch.randn(x.shape, generator=generator, device=device, dtype=dtype)

    for i in range(consts.ts.shape[0]):
        const = DDIMConstants(*(c[i] for c in consts))
        if mask is not None:
            x = masked_blend(x, mask, x0, (sa[const.ts], soma[const.ts]),
                             randn("noise_q", i)).to(dtype)
        v = model_fn(x, const.ts.expand(b))
        x, _ = ddim_step(x, v, const, randn("noise", i), temperature=temperature)
    return x


def stochastic_encode(x0, index, consts: DDIMConstants, noise):
    """DDIMSampler.stochastic_encode (ddim.py:162-167, reference ddim.py:
    303-317): x0 noised to the DDIM step `index` (an int or (B,)) with
    `noise`."""
    nd = (1,) * (x0.ndim - 1)
    idx = torch.as_tensor(index, device=consts.alphas.device)
    sa = torch.sqrt(consts.alphas[idx]).reshape(-1, *nd).to(x0.device)
    soma = consts.sqrt_one_minus[idx].reshape(-1, *nd).to(x0.device)
    return sa * x0 + soma * noise


def ddpm_tables(sched: S.DiffusionSchedule) -> dict[str, np.ndarray]:
    """The ancestral sampler's per-timestep constants as the JAX sampler
    forms them (ddim.py:184-190), float32: sqrt(ac), sqrt(1 - ac),
    sqrt(1 / ac) and sqrt(1 / ac - 1) with ac floored at 1e-20, the
    posterior mean coefficients, and the posterior standard deviation
    exp(0.5 * log variance), taken here on the host so that every device
    gets the same table."""
    ac = sched.alphas_cumprod
    plv = np.asarray(sched.posterior_log_variance_clipped, np.float32)
    return {"sa": sched.sqrt_alphas_cumprod, "soma": sched.sqrt_one_minus_alphas_cumprod,
            "sra": np.sqrt(1.0 / np.maximum(ac, 1e-20)),
            "sram1": np.sqrt(np.maximum(1.0 / np.maximum(ac, 1e-20) - 1.0, 0.0)),
            "pm1": sched.posterior_mean_coef1, "pm2": sched.posterior_mean_coef2,
            "sigma": np.exp(np.float32(0.5) * plv)}


def ddpm_sample(model_fn: Callable, generator: torch.Generator, shape, sched: S.DiffusionSchedule,
                *, parameterization: str = "v", clip_denoised: bool = False,
                dtype=torch.float32, device="cuda", x_T=None, draws=None):
    """Full ancestral DDPM sampling over all T timesteps (DDPM.p_sample_loop,
    ddpm3d.py:274-296; ddim.py:170-221). model_fn(x, t) returns the model
    output in `parameterization` ("v", "eps" or "x0"); x0 is clipped to
    [-1, 1] with clip_denoised; the step's noise is added at every t > 0.
    The algebra runs in fp32. The generator's order: the start noise (where
    x_T is not given), then each step's noise after its model call; draws:
    {"noise": (T, *shape)} in place of the per-step draws."""
    if parameterization not in ("v", "eps", "x0"):
        raise ValueError(f"unknown parameterization {parameterization!r}")
    tab = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
           for k, v in ddpm_tables(sched).items()}
    b = shape[0]
    x = (torch.randn(shape, generator=generator, device=device, dtype=dtype)
         if x_T is None else x_T.to(device=device, dtype=dtype))
    n = sched.num_timesteps
    for i, step in enumerate(range(n - 1, -1, -1)):
        out = model_fn(x, torch.full((b,), step, dtype=torch.int64, device=device)).float()
        xf = x.float()
        if parameterization == "v":
            x0 = tab["sa"][step] * xf - tab["soma"][step] * out
        elif parameterization == "eps":
            x0 = tab["sra"][step] * xf - tab["sram1"][step] * out
        else:
            x0 = out
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        mean = tab["pm1"][step] * x0 + tab["pm2"][step] * xf
        noise = (draws["noise"][i].to(device=device, dtype=dtype) if draws is not None
                 else torch.randn(shape, generator=generator, device=device, dtype=dtype))
        if step > 0:
            mean = mean + tab["sigma"][step] * noise.float()
        x = mean.to(dtype)
    return x
