"""DDIM sampling for a v-parameterized denoiser.

Port of `mudg_tpu/diffusion/ddim.py` (reference `lvdm/models/samplers/
ddim.py`): the per-step constants are gathered on the host into arrays in
sampling order (high t first), and the loop calls the denoiser once per
step. Classifier-free guidance is composed inside the caller's `model_fn`.
Noise comes from an explicit `torch.Generator`.
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


def ddim_sample(model_fn: Callable, generator: torch.Generator, shape, consts: DDIMConstants,
                *, x_T=None, temperature: float = 1.0, dtype=torch.float32, device=None):
    """DDIM loop (ddim.py:134-203). model_fn(x, t) -> v with guidance applied,
    t (B,). The start noise is x_T, or drawn from `generator`; each step's
    noise is drawn from `generator`. Returns the final x."""
    device = device if device is not None else consts.alphas.device
    b = shape[0]
    x = (torch.randn(shape, generator=generator, device=device, dtype=dtype)
         if x_T is None else x_T.to(device=device, dtype=dtype))
    for i in range(consts.ts.shape[0]):
        const = DDIMConstants(*(c[i] for c in consts))
        v = model_fn(x, const.ts.expand(b))
        noise = torch.randn(x.shape, generator=generator, device=device, dtype=dtype)
        x, _ = ddim_step(x, v, const, noise, temperature=temperature)
    return x
