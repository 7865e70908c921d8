"""DPM-Solver++(2M) sampling for a v-parameterized denoiser.

Port of `mudg_tpu/diffusion/dpm.py`: a second-order multistep ODE solver in
the data-prediction (x0) form (Lu et al., arXiv 2211.01095, Algorithm 2),
one model call per step, CFG composed inside the caller's `model_fn` as for
DDIM. The per-step coefficients are computed on the host in float64 and the
loop walks them in sampling order.

At the zero-terminal-SNR step lambda = log(alpha / sigma) = -inf; every
coefficient goes through exp(lambda_s - lambda_t), which degenerates to 0,
so the first update is x = sigma_t * x_T + alpha_t * x0_pred. The second-
order weight g1 is 0 on the first step, wherever the log-SNR interval is not
finite, and on the last step (lower_order_final). With the schedule's
dynamic rescale, x0 carries the same scale_prev / scale ratio as the DDIM
step. With a latent mask, each step first blends x against x0 q-sampled
to its timestep, as the DDIM loop does (dpm.py:122-137).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import schedules as S


class DPMPPConstants(NamedTuple):
    """Per-step constants in sampling order (index 0 = highest timestep)."""
    ts: torch.Tensor           # (S,) int64 source (model-call) timesteps
    alpha_s: torch.Tensor      # (S,) sqrt(ac) at the source step (v -> x0)
    sigma_s: torch.Tensor      # (S,) sqrt(1 - ac) at the source step
    c_x: torch.Tensor          # (S,) sigma_t / sigma_s
    c_d: torch.Tensor          # (S,) alpha_t * (1 - e^{-h})
    g1: torch.Tensor           # (S,) second-order weight h / (2 h_prev)
    scale_ratio: torch.Tensor  # (S,) scale_prev / scale (ones if disabled)


def make_dpmpp_constants(sched: S.DiffusionSchedule, num_steps: int, *,
                         timestep_spacing: str = "uniform_trailing",
                         device=None) -> DPMPPConstants:
    """The 2M update coefficients (dpm.py:48-96). Source steps come from the
    DDIM selector, targets follow DDIM's alphas_prev convention, so a 2M run
    visits the DDIM grid."""
    steps = S.make_ddim_timesteps(timestep_spacing, num_steps, sched.num_timesteps)
    ac = np.asarray(sched.alphas_cumprod, dtype=np.float64)
    ac_s = ac[steps]
    ac_t = np.concatenate([ac[0:1], ac_s[:-1]])
    a_s, s_s = np.sqrt(ac_s), np.sqrt(1.0 - ac_s)
    a_t, s_t = np.sqrt(ac_t), np.sqrt(1.0 - ac_t)
    with np.errstate(divide="ignore"):
        lam_s = np.log(a_s) - np.log(s_s)
        lam_t = np.log(a_t) - np.log(s_t)
    h = lam_t - lam_s
    e_mh = np.exp(-h)
    c_x = s_t / s_s
    c_d = a_t * (1.0 - e_mh)
    # ascending-step order: h_prev is the next entry (the higher-t interval)
    h_prev = np.concatenate([h[1:], [np.inf]])
    with np.errstate(invalid="ignore"):
        g1 = np.where(np.isfinite(h) & np.isfinite(h_prev) & (h_prev > 0),
                      h / (2.0 * h_prev), 0.0)
    g1[0] = 0.0
    if sched.scale_arr is not None:
        scale = np.asarray(sched.scale_arr, np.float64)[steps]
        ratio = np.concatenate([scale[0:1], scale[:-1]]) / scale
    else:
        ratio = np.ones_like(c_x)

    def rev(x, dtype=torch.float32):
        return torch.as_tensor(x[::-1].copy(), dtype=dtype, device=device)

    return DPMPPConstants(ts=rev(steps, torch.int64), alpha_s=rev(a_s), sigma_s=rev(s_s),
                          c_x=rev(c_x), c_d=rev(c_d), g1=rev(np.nan_to_num(g1)),
                          scale_ratio=rev(ratio))


def dpmpp_sample(model_fn: Callable, generator: torch.Generator, shape,
                 consts: DPMPPConstants, *, x_T=None, mask=None, x0=None,
                 sched: S.DiffusionSchedule | None = None, dtype=torch.float32, device=None,
                 draws=None):
    """DPM-Solver++(2M) loop (dpm.py:99-154), deterministic after the start
    noise: x_T, or drawn from `generator`. model_fn(x, t) -> v with guidance
    applied, t (B,). With `mask` (and x0, sched), each step's x is first
    blended against x0 q-sampled to its timestep (`ddim.masked_blend`), its
    noise drawn from `generator` before the model call, or taken from
    draws={"noise_q": (S, *shape)} (the parity tests pass JAX's). The
    algebra runs in fp32; x and the previous x0 are kept in `dtype` between
    steps. Returns the final x."""
    from .ddim import masked_blend, sched_tables

    device = device if device is not None else consts.alpha_s.device
    b = shape[0]
    x = (torch.randn(shape, generator=generator, device=device, dtype=dtype)
         if x_T is None else x_T.to(device=device, dtype=dtype))
    if mask is not None:
        if x0 is None or sched is None:
            raise ValueError("a mask needs x0 and sched")
        sa, soma = sched_tables(sched, device)
    m_prev = torch.zeros(shape, device=device, dtype=dtype)
    nd = (1,) * (len(shape) - 1)
    for i in range(consts.ts.shape[0]):
        c = DPMPPConstants(*(a[i].to(device) for a in consts))
        if mask is not None:
            noise_q = (draws["noise_q"][i].to(device=device, dtype=dtype) if draws is not None
                       else torch.randn(shape, generator=generator, device=device, dtype=dtype))
            x = masked_blend(x, mask, x0, (sa[c.ts], soma[c.ts]), noise_q).to(dtype)
        v = model_fn(x, c.ts.expand(b))
        xf, vf = x.float(), v.float()
        r = lambda a: a.reshape(1, *nd)   # noqa: E731
        m = (r(c.alpha_s) * xf - r(c.sigma_s) * vf) * r(c.scale_ratio)
        d = m + r(c.g1) * (m - m_prev.float())
        x = (r(c.c_x) * xf + r(c.c_d) * d).to(dtype)
        m_prev = m.to(dtype)
    return x
