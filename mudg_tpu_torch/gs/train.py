"""Diffusion-supervised 3DGS scene refinement (port of `mudg_tpu/gs/train.py`).

Optimizes a fixed-capacity Gaussian set against generated supervision: RGB
(L1 + D-SSIM), optional depth L1 on the alpha-normalized expected depth and
an optional semantic cross-entropy. Per-field Adam with optax's `adam`
semantics. Adaptive density control (clone / split / prune) runs on the host
between steps and reuses inactive capacity slots, so shapes never change.
Steps are plain functions (no compilation). The tile rasterizer's pair
buffer holds at most `GSConfig.max_pairs` pairs (JAX's 1 << 21 by default;
`fit_scene` warns on a step that drops pairs), or exactly what the view
needs with `max_pairs=None`, so no budget is resolved or re-resolved.
"""
from __future__ import annotations

import dataclasses
import sys
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from .gaussians import Gaussians, apply_group_transforms, with_sem, with_sh
from .rasterize import rasterize
from .tile_raster import rasterize_tiles


@dataclasses.dataclass(frozen=True)
class GSConfig:
    lr_means: float = 1.6e-4
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 0.05
    lr_colors: float = 2.5e-3
    lr_sh: float = 1.25e-4           # 3DGS convention: feature lr / 20
    sh_degree: int = 0               # 0 = view-independent color; 1..3 adds
                                     # rest-band SH coefficients
    ssim_weight: float = 0.2
    depth_weight: float = 0.1
    semantic_weight: float = 0.0     # > 0 trains Gaussians.sem against
                                     # per-view class-id maps
    semantic_classes: int = 19       # cityscapes train ids (SegFormer)
    lr_sem: float = 2.5e-3
    appearance: bool = False         # per-view affine color compensation of
                                     # the render (training views only)
    lr_appearance: float = 1e-3
    densify_every: int = 100
    opacity_reset_every: int = 3000  # 3DGS floater control (0 disables)
    densify_grad_thresh: float = 2e-4
    prune_opacity_thresh: float = 0.005
    split_scale_thresh: float = 0.05   # world units; split if larger
    max_per_tile: int = 256          # capped-path capacity (backend="xla")
    tiles_per_gaussian: int = 16     # capped-path per-gaussian tile cap
    backend: str = "auto"            # "auto" | "pallas" | "xla": "auto" and
                                     # "pallas" are the tile rasterizer
                                     # (kernel 13 on the card), "xla" the
                                     # capped sort+scan path
    max_pairs: int | None = 1 << 21  # tile-path global pair budget per view,
                                     # as the JAX package's: past it the
                                     # deepest-sorted pairs are dropped
                                     # (and fit_scene warns); None = sized
                                     # exactly every call (nothing dropped)


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_LR_FIELD = {"means": "lr_means", "log_scales": "lr_scales", "quats": "lr_quats",
             "opacity": "lr_opacity", "colors": "lr_colors", "sh": "lr_sh", "sem": "lr_sem",
             "appearance": "lr_appearance"}


def gaussian_window(size=11, sigma=1.5, device=None):
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.as_tensor(np.outer(g, g), dtype=torch.float32, device=device)


def ssim(a, b, window=None):
    """Single-scale SSIM of (H, W, C) images in [0, 1]. The 11x11 filter runs
    as an fp32 convolution with TF32 off (cuDNN's default would keep ~3
    digits)."""
    if window is None:
        window = gaussian_window(device=a.device)
    w = window[None, None]

    def filt(x):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return torch.nn.functional.conv2d(x.permute(2, 0, 1)[:, None], w,
                                              padding=w.shape[-1] // 2)[:, 0].permute(1, 2, 0)

    mu_a, mu_b = filt(a), filt(b)
    sig_a = filt(a * a) - mu_a ** 2
    sig_b = filt(b * b) - mu_b ** 2
    sig_ab = filt(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * sig_ab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (sig_a + sig_b + c2))
    return s.mean()


class GSTrainState(NamedTuple):
    gaussians: Gaussians
    opt_state: dict            # {"count": int, "mu": {field: t}, "nu": {field: t}}
    grad_accum: torch.Tensor   # (N,) accumulated positional gradient norms
    grad_count: torch.Tensor   # (N,)
    step: int
    appearance: torch.Tensor | None = None  # (V, 3, 4) per-view affine color


def _float_fields(g: Gaussians) -> dict:
    f = {"means": g.means, "log_scales": g.log_scales, "quats": g.quats,
         "opacity": g.opacity, "colors": g.colors}
    if g.sh is not None:
        f["sh"] = g.sh
    if g.sem is not None:
        f["sem"] = g.sem
    return f


def _with_floats(g: Gaussians, f: dict) -> Gaussians:
    return Gaussians(means=f["means"], log_scales=f["log_scales"], quats=f["quats"],
                     opacity=f["opacity"], colors=f["colors"], active=g.active,
                     sh=f.get("sh"), sem=f.get("sem"), group=g.group)


def _train_params(state: GSTrainState) -> dict:
    f = _float_fields(state.gaussians)
    if state.appearance is not None:
        f["appearance"] = state.appearance
    return f


def adam_init(params: dict) -> dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def adam_update(cfg: GSConfig, opt_state: dict, grads: dict, params: dict, masks=None):
    """One bias-corrected Adam step per field at the field's learning rate
    (optax.adam: b1 0.9, b2 0.999, eps 1e-8, eps_root 0). `masks` multiply a
    field's update (not its moments). Returns (new params, new state)."""
    count = opt_state["count"] + 1
    mu, nu, new = {}, {}, {}
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            mu[k] = ADAM_B1 * opt_state["mu"][k] + (1 - ADAM_B1) * g
            nu[k] = ADAM_B2 * opt_state["nu"][k] + (1 - ADAM_B2) * g * g
            m_hat = mu[k] / (1 - ADAM_B1 ** count)
            v_hat = nu[k] / (1 - ADAM_B2 ** count)
            upd = -getattr(cfg, _LR_FIELD[k]) * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
            if masks is not None and k in masks:
                upd = upd * masks[k]
            new[k] = p + upd
    return new, {"count": count, "mu": mu, "nu": nu}


def _identity_appearance(n_views: int, device):
    A = torch.cat([torch.eye(3), torch.zeros(3, 1)], -1).to(device)
    return A[None].repeat(n_views, 1, 1)


def init_state(g: Gaussians, cfg: GSConfig, n_views: int = 0) -> GSTrainState:
    appearance = (_identity_appearance(n_views, g.means.device)
                  if cfg.appearance and n_views else None)
    state = GSTrainState(gaussians=g, opt_state={}, grad_accum=g.means.new_zeros(g.n),
                         grad_count=g.means.new_zeros(g.n), step=0, appearance=appearance)
    return state._replace(opt_state=adam_init(_train_params(state)))


def pick_raster(cfg: GSConfig, width: int, height: int):
    """The rasterizer of cfg.backend: "auto" and "pallas" the tile
    rasterizer, "xla" the capped sort+scan path."""
    if cfg.backend in ("auto", "pallas"):
        return partial(rasterize_tiles, width=width, height=height, max_pairs=cfg.max_pairs)
    if cfg.backend == "xla":
        return partial(rasterize, width=width, height=height, max_per_tile=cfg.max_per_tile,
                       tiles_per_gaussian=cfg.tiles_per_gaussian)
    raise ValueError(f"unknown backend {cfg.backend!r}")


def photometric_loss(color, target_rgb, cfg: GSConfig):
    """(1 - ssim_weight) * L1 + ssim_weight * D-SSIM of one rendered view."""
    l1 = (color - target_rgb).abs().mean()
    return (1 - cfg.ssim_weight) * l1 + cfg.ssim_weight * (1.0 - ssim(color, target_rgb))


def gs_loss(cfg: GSConfig, raster, floats: dict, active, group, K, w2c, target_rgb,
            target_depth=None, depth_mask=None, obj_T=None, obj_vis=None, sem_ids=None,
            view_idx: int = 0):
    """The refinement loss of one view: (loss, RasterOut)."""
    g = _with_floats(Gaussians(None, None, None, None, None, active, group=group), floats)
    if obj_T is not None:
        g = apply_group_transforms(g, obj_T, obj_vis)
    semantic = g.sem is not None and sem_ids is not None
    if semantic:
        out = raster(g, K, w2c, features=torch.softmax(g.sem, -1))
    else:
        out = raster(g, K, w2c)
    color = out.color
    if "appearance" in floats:
        # the view's exposure drift is absorbed by an affine map of the render
        A = floats["appearance"][view_idx]
        color = torch.einsum("hwc,dc->hwd", color, A[:, :3]) + A[:, 3]
    loss = photometric_loss(color, target_rgb, cfg)
    if target_depth is not None:
        d = out.depth / out.alpha.clamp(min=1e-6)
        dl = (d - target_depth).abs() * depth_mask
        loss = loss + cfg.depth_weight * dl.sum() / depth_mask.sum().clamp(min=1.0)
    if semantic:
        # alpha-normalized class distribution against the target id, on
        # covered pixels only
        p = out.features / out.alpha[..., None].clamp(min=1e-6)
        tgt = torch.nn.functional.one_hot(sem_ids.long(), p.shape[-1]).float()
        ce = -torch.log((p * tgt).sum(-1).clamp(min=1e-8))
        mask = (out.alpha > 0.5).float()
        loss = loss + cfg.semantic_weight * (ce * mask).sum() / mask.sum().clamp(min=1.0)
    return loss, out


def make_gs_train_step(cfg: GSConfig, *, width: int, height: int):
    """step(state, K, w2c, target_rgb, target_depth, depth_mask, obj_T=None,
    obj_vis=None, sem_ids=None, view_idx=0) -> (state, {"loss", "n_dropped"})."""
    raster = pick_raster(cfg, width, height)

    def step(state: GSTrainState, K, w2c, target_rgb, target_depth, depth_mask, obj_T=None,
             obj_vis=None, sem_ids=None, view_idx=0):
        view_idx = int(view_idx)
        params = _train_params(state)
        floats = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss, out = gs_loss(cfg, raster, floats, state.gaussians.active,
                                state.gaussians.group, K, w2c, target_rgb, target_depth,
                                depth_mask, obj_T, obj_vis, sem_ids, view_idx)
            grads = torch.autograd.grad(loss, list(floats.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if gr is None else gr
                 for (k, v), gr in zip(floats.items(), grads)}
        masks = None
        if "appearance" in floats:
            # only the sampled view's affine moves: Adam's momentum would
            # otherwise keep drifting every other view's row
            one = torch.zeros(floats["appearance"].shape[0], device=loss.device)
            one[view_idx] = 1.0
            masks = {"appearance": one[:, None, None]}
        new, opt_state = adam_update(cfg, state.opt_state, grads, params, masks)
        appearance = new.pop("appearance", None)
        pos_grad = torch.linalg.norm(grads["means"], dim=-1)
        new_state = GSTrainState(gaussians=_with_floats(state.gaussians, new),
                                 opt_state=opt_state,
                                 grad_accum=state.grad_accum + pos_grad,
                                 grad_count=state.grad_count + (pos_grad > 0).float(),
                                 step=state.step + 1, appearance=appearance)
        return new_state, {"loss": loss.detach(), "n_dropped": out.n_dropped}

    return step


def reset_opacity(state: GSTrainState, cfg: GSConfig, ceiling: float = 0.01) -> GSTrainState:
    """3DGS periodic opacity reset: clamp every opacity to <= ceiling and
    reset the Adam moments."""
    logit = float(np.log(ceiling / (1 - ceiling)))
    g = state.gaussians._replace(opacity=torch.clamp(state.gaussians.opacity, max=logit))
    state = state._replace(gaussians=g)
    return state._replace(opt_state=adam_init(_train_params(state)))


def densify_and_prune(state: GSTrainState, cfg: GSConfig) -> GSTrainState:
    """Host-side adaptive density control reusing inactive slots, with the
    JAX package's draws (np.random.default_rng(step)). Prune: opacity below
    threshold. Clone: high positional gradient and small scale (copy, slight
    offset). Split: high gradient and large scale (shrink by 1.6, two
    children). Shapes never change."""
    g = state.gaussians
    dev = g.means.device

    def host(x):
        return None if x is None else x.detach().cpu().numpy().copy()

    accum = host(state.grad_accum)
    count = np.maximum(host(state.grad_count), 1.0)
    avg_grad = accum / count
    active = host(g.active)
    opacity = 1 / (1 + np.exp(-host(g.opacity)))
    scales = np.exp(host(g.log_scales)).max(axis=-1)
    means, log_scales, quats = host(g.means), host(g.log_scales), host(g.quats)
    opa, colors, sh, sem, group = (host(g.opacity), host(g.colors), host(g.sh), host(g.sem),
                                   host(g.group))

    prune = active & (opacity < cfg.prune_opacity_thresh)
    active[prune] = False
    hot = active & (avg_grad > cfg.densify_grad_thresh)
    clone_src = np.where(hot & (scales <= cfg.split_scale_thresh))[0]
    split_src = np.where(hot & (scales > cfg.split_scale_thresh))[0]
    free = np.where(~active)[0]

    def copy_row(dst, src):
        log_scales[dst] = log_scales[src]
        quats[dst] = quats[src]
        opa[dst] = opa[src]
        colors[dst] = colors[src]
        for a in (sh, sem, group):
            if a is not None:
                a[dst] = a[src]
        active[dst] = True

    fi = 0
    rng = np.random.default_rng(int(state.step))
    for src in clone_src:
        if fi >= len(free):
            break
        dst = free[fi]
        fi += 1
        means[dst] = means[src] + rng.normal(0, np.exp(log_scales[src]).mean() * 0.1, 3)
        copy_row(dst, src)
    for src in split_src:
        if fi >= len(free):
            break
        dst = free[fi]
        fi += 1
        offset = rng.normal(0, np.exp(log_scales[src]).mean() * 0.5, 3)
        means[dst] = means[src] + offset
        means[src] = means[src] - offset
        log_scales[src] = log_scales[src] - np.log(1.6)
        copy_row(dst, src)

    def dev_t(x):
        return None if x is None else torch.from_numpy(x).to(dev)

    new_g = Gaussians(means=dev_t(means), log_scales=dev_t(log_scales), quats=dev_t(quats),
                      opacity=dev_t(opa), colors=dev_t(colors), active=dev_t(active),
                      sh=dev_t(sh), sem=dev_t(sem), group=dev_t(group))
    new_state = GSTrainState(gaussians=new_g, opt_state={},
                             grad_accum=torch.zeros_like(state.grad_accum),
                             grad_count=torch.zeros_like(state.grad_count), step=state.step,
                             appearance=state.appearance)
    return new_state._replace(opt_state=adam_init(_train_params(new_state)))


def fit_scene(gaussians: Gaussians, views: list[dict], cfg: GSConfig, *, width: int,
              height: int, steps: int = 1000, log_every: int = 100, seed: int = 0,
              on_step=None):
    """views: dicts of tensors on the gaussians' device with K, w2c, rgb
    (H, W, 3) in [0, 1], optional depth (H, W) + depth_mask, sem_ids, obj_T
    and obj_vis. The view of each step is drawn from
    np.random.default_rng(seed). `on_step(i, state, metrics)`, if given,
    runs after every step. Returns the trained state and the loss history."""
    if cfg.sh_degree > 0 and gaussians.sh is None:
        gaussians = with_sh(gaussians, cfg.sh_degree)
    if cfg.semantic_weight > 0 and gaussians.sem is None:
        gaussians = with_sem(gaussians, cfg.semantic_classes)
    state = init_state(gaussians, cfg, n_views=len(views))
    step_fn = make_gs_train_step(cfg, width=width, height=height)
    rng = np.random.default_rng(seed)
    zeros = gaussians.means.new_zeros((height, width))
    history = []
    for i in range(steps):
        vi = int(rng.integers(len(views)))
        v = views[vi]
        td, tm = v.get("depth"), v.get("depth_mask")
        if td is None:
            td, tm = zeros, zeros
        state, metrics = step_fn(state, v["K"], v["w2c"], v["rgb"], td, tm, v.get("obj_T"),
                                 v.get("obj_vis"), v.get("sem_ids"), vi)
        nd = int(metrics.get("n_dropped", 0))
        if nd > 0:
            print(f"# gs.fit_scene step {i + 1}: {nd} pairs dropped on view {vi} "
                  f"(max_pairs {cfg.max_pairs})", file=sys.stderr)
        if on_step is not None:
            on_step(i, state, metrics)
        if cfg.opacity_reset_every and (i + 1) % cfg.opacity_reset_every == 0:
            state = reset_opacity(state, cfg)
        if (i + 1) % cfg.densify_every == 0:
            state = densify_and_prune(state, cfg)
        if (i + 1) % log_every == 0:
            history.append({"step": i + 1, "loss": float(metrics["loss"])})
    return state, history
