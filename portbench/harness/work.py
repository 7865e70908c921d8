"""The yardstick's arithmetic: the H100's peaks, the least time of a piece
of work, the work of each port kernel's call from its shapes, the kernel
sites of one UNet forward, and the model FLOPs of a served window counted
on the plain reference.

The peaks and the per-call work functions are copied from `chip_smoke.py`
(`PEAK_*`, `bound`, `work_*`), so that later changes to that script move
nothing here.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FLOPS = 989e12   # bf16 tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def least_s(flops, nbytes, peak=PEAK_FLOPS):
    """The least seconds the card could take for `flops` operations at
    `peak` and `nbytes` bytes moved."""
    return max(flops / peak, nbytes / PEAK_BYTES)


# Work of one call: (FLOPs, bytes), each input read once and each output
# written once (bf16 activations and weights, fp32 norms and biases).
def work_spatial(b, l, c):
    return (8 * b * l * c * c + 4 * b * l * l * c,
            2 * 2 * b * l * c + 2 * 4 * c * c + 4 * 3 * c)


def work_temporal(n, t, c):
    m = n * t
    return (2 * (8 * m * c * c + 4 * m * t * c),
            2 * 2 * m * c + 2 * (2 * 4 * c * c + 4 * 3 * c))


def work_ff(m, c, block):
    inner = 4 * c
    return (6 * m * c * inner,
            2 * 2 * m * c + 2 * 3 * c * inner + 4 * (2 * inner + c + (2 * c if block else 0)))


def work_tconv(b, t, h, w, c):
    m = b * t * h * w
    return 6 * m * c * c, 2 * 2 * m * c + 2 * 3 * c * c + 4 * 3 * c


def work_flash(b, l, h, d, itemsize=2):
    return 4 * b * h * l * l * d, 4 * itemsize * b * l * h * d + 4 * b * h * l


# The kernel sites of a bf16 UNet forward, by the port's dispatch
# predicates as they stand (kernels/*.eligible): kernel 1 (spatial_attn) at
# a spatial transformer's self-attention where C = 64 heads, C <= 640 and
# L % 64 == 0, else kernel 5 (flash_attention) where L >= 512 and
# L % 64 == 0; kernel 2 (temporal_attn, both self-attentions of a block)
# where C <= 640 and N T % 64 == 0; kernel 3 (geglu_ff) at every
# transformer block's feed-forward whose rows are a multiple of 256, with
# the LN and residual inside below C = 640; kernel 4 (gn_silu_tconv) at each
# stage of a temporal conv block below C = 640.
SPATIAL_MAX_C, TEMPORAL_MAX_C, TCONV_MAX_C, FLASH_MIN_L = 640, 640, 639, 512


def unet_sites(u: dict, batch: int, frames: int, h: int, w: int) -> dict[str, list]:
    """kernel name -> [(FLOPs, bytes) per call] of one UNet forward over
    latents (batch, frames, h, w), from the configuration's block plan."""
    from ..reference.mdm import unet_plan

    sites = {"spatial_attn": [], "temporal_attn": [], "geglu_ff": [], "gn_silu_tconv": [],
             "flash_attention": []}
    dh = u["num_head_channels"]

    def transformer(kind, c, hh, ww, inner=None):
        c = inner or c
        rows = batch * frames * hh * ww
        if kind == "spatial":
            l = hh * ww
            if c == (c // 64) * 64 and dh == 64 and c <= SPATIAL_MAX_C and l % 64 == 0:
                sites["spatial_attn"].append(work_spatial(batch * frames, l, c))
            elif l >= FLASH_MIN_L and l % 64 == 0 and dh == 64:
                sites["flash_attention"].append(work_flash(batch * frames, l, c // 64, 64))
        elif c <= TEMPORAL_MAX_C and dh == 64 and rows % 64 == 0:
            sites["temporal_attn"].append(work_temporal(batch * hh * ww, frames, c))
        if rows % 256 == 0 and c % 32 == 0:
            sites["geglu_ff"].append(work_ff(rows, c, c < 640))

    inp, mid, out = unet_plan(u)
    ds = 1
    transformer("temporal", u["model_channels"], h, w, inner=8 * dh)     # init_attn
    for block in (*inp, mid, *out):
        for lt, a in block:
            hh, ww = math.ceil(h / ds), math.ceil(w / ds)
            if lt in ("spatial", "temporal"):
                transformer(lt, a["ch"], hh, ww)
            elif lt == "res" and a["c_out"] <= TCONV_MAX_C and a["c_out"] % 32 == 0:
                sites["gn_silu_tconv"] += [work_tconv(batch, frames, hh, ww, a["c_out"])] * 4
            elif lt == "down":
                ds *= 2
            elif lt == "up":
                ds //= 2
    return sites


def kernel_least_s(counts: dict, sites: dict) -> float | None:
    """The least seconds of the port kernel launches `counts` (name ->
    launches), each at the mean work of that kernel's `sites`; None where a
    kernel launched that has no site in the model."""
    total = 0.0
    for name, n in counts.items():
        if not n:
            continue
        calls = sites.get(name)
        if not calls:
            return None
        total += n * sum(least_s(f, b) for f, b in calls) / len(calls)
    return total


def serve_flops(cfg: dict, mix: dict, h: int, w: int) -> float:
    """Model FLOPs of one served window: every UNet forward of the sampler
    (tasks x CFG variants a step), the towers and resampler over each task's
    condition and null inputs, the VAE encode of each task's sparse color
    and depth frames and the decode of each task's clip, counted by running
    the plain reference on the meta device under FlopCounterMode."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import mdm as R

    u, v = cfg["unet"], cfg["vae"]
    tasks, frames = len(mix["class_labels"]), cfg["video_length"]
    variants = 2                       # 2-point CFG: unconditional, full
    f = 2 ** (len(v["ch_mult"]) - 1)
    meta = dict(device="meta")
    P = {k: torch.empty(s, **meta) for k, s in R.param_shapes(cfg).items()}
    n = variants * tasks
    lt = u["text_context_len"] + frames * u["image_tokens_per_frame"]
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        R.unet(P, u, torch.empty(n, frames, h // f, w // f, u["in_channels"], **meta),
               torch.zeros(n, dtype=torch.long, **meta),
               torch.empty(n, lt, u["context_dim"], **meta),
               torch.zeros(n, dtype=torch.long, **meta), torch.zeros(n, dtype=torch.long, **meta))
    unet = counter.get_total_flops()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        R.vae_encode(P, v, torch.empty(2 * tasks * frames, h, w, 3, **meta))
        R.vae_decode(P, v, torch.empty(tasks * frames, h // f, w // f, v["z_channels"], **meta))
        R.text_encode(P, cfg["clip_text"], torch.zeros(
            2 * tasks, cfg["clip_text"]["context_length"], dtype=torch.long, **meta))
        R.resample(P, cfg["resampler"], R.image_encode(P, cfg["clip_image"],
                                                       torch.empty(2 * tasks, h, w, 3, **meta)))
    return float(mix["steps"] * unet + counter.get_total_flops())


# The backward functions: their inputs include the fp32 parameters (read once)
# and their outputs the fp32 weight gradients (written once). Copied from
# chip_smoke.py.
def work_flash_bwd(b, l, h, d, itemsize=2):
    """Five L x L x d products per (batch, head); q, k, v, o, dO in, dq, dk,
    dv out, lse in (fp32)."""
    return 10 * b * h * l * l * d, itemsize * 8 * b * l * h * d + 4 * b * h * l


def work_temporal_bwd(rows, c):
    """Both stages: per stage 11 C x C products per row and 6 per row and
    head over 16 keys; tokens, h1, dy in and dx out (bf16); two stages' 4C^2
    + 3C parameters in and gradients out."""
    return (4 * rows * c * (11 * c + 96),
            2 * 4 * rows * c + 2 * 2 * 4 * (4 * c * c + 3 * c))


def work_ff_bwd(m, c):
    """8 M x C x inner multiply-adds; x, dy in, dx out (bf16); W1, b1, W2 in
    and their and b2's gradients out (fp32)."""
    inner = 4 * c
    return 16 * m * c * inner, 2 * 3 * m * c + 4 * (6 * c * inner + 4 * inner + c)


# The training dispatch (impl="train"): kernel 1 off; kernel 5 (and 6) at
# every spatial self-attention with L >= 512; kernel 2 (and 9) at the
# temporal blocks of C <= 512; kernel 3 (and 10) at the feed-forwards whose
# rows are a multiple of 256.
TRAIN_TEMPORAL_MAX_C = 512


def train_sites(u: dict, batch: int, frames: int, h: int, w: int) -> dict[str, list]:
    """kernel name -> [(FLOPs, bytes) per call] of one training micro-step's
    UNet (forward kernels and their backward kernels)."""
    from ..reference.mdm import unet_plan

    sites = {k: [] for k in ("flash_attention", "flash_attention_bwd", "temporal_attn",
                             "temporal_attn_bwd", "geglu_ff", "geglu_ff_bwd")}
    dh = u["num_head_channels"]

    def transformer(kind, c, hh, ww):
        rows = batch * frames * hh * ww
        if kind == "spatial":
            l = hh * ww
            if l >= FLASH_MIN_L and l % 64 == 0 and dh == 64:
                sites["flash_attention"].append(work_flash(batch * frames, l, c // 64, 64))
                sites["flash_attention_bwd"].append(work_flash_bwd(batch * frames, l, c // 64, 64))
        elif c <= TRAIN_TEMPORAL_MAX_C and dh == 64:
            sites["temporal_attn"].append(work_temporal(batch * hh * ww, frames, c))
            sites["temporal_attn_bwd"].append(work_temporal_bwd(rows, c))
        if rows % 256 == 0 and c % 32 == 0:
            sites["geglu_ff"].append(work_ff(rows, c, c < 640))
            sites["geglu_ff_bwd"].append(work_ff_bwd(rows, c))

    inp, mid, out = unet_plan(u)
    ds = 1
    transformer("temporal", 8 * dh, h, w)     # init_attn
    for block in (*inp, mid, *out):
        for lt, a in block:
            hh, ww = math.ceil(h / ds), math.ceil(w / ds)
            if lt in ("spatial", "temporal"):
                transformer(lt, a["ch"], hh, ww)
            elif lt == "down":
                ds *= 2
            elif lt == "up":
                ds //= 2
    return sites


def train_flops(cfg: dict, mix: dict) -> float:
    """Model FLOPs of one optimizer step: per micro-batch three times the
    trainable forward (the UNet and the resampler) and once the frozen ones
    (the VAE encode of the dense, sparse color and sparse depth videos, the
    text and image towers), remat's recompute not counted; counted by the
    plain reference on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import mdm as R

    u, v = cfg["unet"], cfg["vae"]
    b, frames, h, w = mix["batch_size"], cfg["video_length"], cfg["height"], cfg["width"]
    f = 2 ** (len(v["ch_mult"]) - 1)
    meta = dict(device="meta")
    P = {k: torch.empty(s, **meta) for k, s in R.param_shapes(cfg).items()}
    lt = u["text_context_len"] + frames * u["image_tokens_per_frame"]
    trainable = FlopCounterMode(display=False)
    with trainable, torch.no_grad():
        R.unet(P, u, torch.empty(b, frames, h // f, w // f, u["in_channels"], **meta),
               torch.zeros(b, dtype=torch.long, **meta),
               torch.empty(b, lt, u["context_dim"], **meta),
               torch.zeros(b, dtype=torch.long, **meta), torch.zeros(b, dtype=torch.long, **meta))
        R.resample(P, cfg["resampler"], torch.empty(
            b, (cfg["clip_image"]["image_size"] // cfg["clip_image"]["patch_size"]) ** 2 + 1,
            cfg["resampler"]["embedding_dim"], **meta))
    frozen = FlopCounterMode(display=False)
    with frozen, torch.no_grad():
        R.vae_encode(P, v, torch.empty(3 * b * frames, h, w, 3, **meta))
        R.text_encode(P, cfg["clip_text"], torch.zeros(b, cfg["clip_text"]["context_length"],
                                                       dtype=torch.long, **meta))
        R.image_encode(P, cfg["clip_image"], torch.empty(b, h, w, 3, **meta))
    per_micro = 3 * trainable.get_total_flops() + frozen.get_total_flops()
    return float(mix["accum_steps"] * per_micro)
