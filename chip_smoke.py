#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mudg_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2,3,4,5,6,7,8] [--out DIR] [--profile]

Phases:
  1. device and build: the card's name and power limit, torch and CUDA
     versions, and the nvcc build of every kernel from csrc/;
  2. each kernel against its plain PyTorch version at every shape of an
     MDM512 and an MDM1024 UNet forward, plus one long flash-attention shape
     (random bf16 inputs, kernels 1-2's logits ~N(0, 9); max|diff| <= 3e-2 *
     max|ref| on the output less the residual input where the kernel adds
     one; kernel 5's logsumexp within 1e-2; a plain version with a planted
     fault, zeroed attention or half the keys, must miss that bound), with
     the median CUDA-event time of the kernel, of its plain version and, for
     kernel 5, of torch's scaled_dot_product_attention (a yardstick only,
     never on the port's path), beside the least time the card could take
     for the same work (bytes or operations at its peaks); then the backward
     kernels 6, 9 and 10 against their plain backward versions at every
     training shape of a batch-1 micro-step at MDM512 and at MDM1024
     (kernel 6 at each spatial self-attention length, each after kernel 5's
     forward at that shape, kernel 9 at C = 320 and 512, kernel 10 at every
     FF site; peaked logits for kernels 6 and 9; each gradient
     within max|diff| <= 5e-2 * max|ref|; planted faults: kernel 6 with delta
     dropped and with half the keys, kernel 9 without the softmax
     Jacobian's row-sum term, kernel 10 without the g * pdf(g) term, each of
     which must miss it), kernel 6 beside the backward of torch's
     scaled_dot_product_attention under autograd (timed only);
  3. one full-width MDM512 UNetConfig() forward at batch 2 (40x64 latent,
     re-randomized weights) on three paths: kernels bf16, plain bf16, plain
     fp32 (TF32 off, impl="plain"); the kernel path's relative L2 error against fp32 must
     stay within 1.5x the plain bf16 path's + 5e-3, and every kernel must
     have been launched at its MDM512 sites (10 / 11 / 33 / 20 / 0);
  4. the MDM512 main path: `sample_clip`, 25-step DDIM with 2-point CFG
     (guidance 7.5, rescale 0.7, eta 1.0, uniform_trailing) and a VAE
     decode of 16 frames at 320x512, bf16, seeded; the launch counts are
     reset just before it and read just after;
  5. phase 3 at MDM1024 (72x128 latent, the plain fp32 attention in chunks
     of the (batch, head) pairs), sites 10 / 11 / 33 / 20 / 5;
  6. the MDM1024 main path: `sample` at the `mdm1024` preset for one task,
     from seeded sparse RGB and depth videos (1, 16, 576, 1024, 3) and seeded
     token ids through the text and image towers, the resampler, the VAE
     encode, 25-step DDIM with 2-point CFG (as phase 4) and the decode, all
     five sub-models random, bf16; counts reset just before, read just after;
     then each stage of the clip outside the UNet timed alone (host clock);
  7. full-width MDM512 training: `MDMConfig()`, all five sub-models random
     (UNet and resampler fp32 masters, the frozen towers bf16), batch 1,
     accumulation 2, seeded (1, 16, 320, 512, 3) dense, sparse and depth
     videos, seeded token ids and a class label, bf16 compute, remat=True:
     one micro-step's trainable gradients with dropout off and the same
     draws on three paths (kernels bf16, plain bf16, plain fp32 with TF32
     off), the kernel path's relative L2 error against fp32 within 1.5x
     the plain bf16 path's + 5e-3; then a warm-up and three timed optimizer
     steps (host clock, synchronized) with finite loss and gradient norm,
     moved parameters, launches at exactly the training sites x
     micro-steps (counts reset just before, read just after), peak memory;
     then the step's layers each timed alone (VAE encode, towers, the
     loss's forward, a micro-step, the AdamW update);
  8. one stage-2 optimizer step at MDM1024 (`stage2_config()`, 576x1024,
     `temporal_frozen_mask` as the grad mask): the frozen temporal leaves move by weight decay
     alone, kernel 6 runs at L = 9216 inside the path, launches at the
     MDM1024 training sites x 2 micro-steps.
It prints the kernel table as one JSON line: "ms", "plain_ms", "bound_ms" and
"library_ms" are one UNet forward's worth of a forward kernel at each of the
two configurations, summed, and one batch-1 training micro-step's backward
at each configuration, summed, for a backward kernel (phase 2's per-call
medians or bounds times the sites; kernel 5 at the training lengths has
sites 0 there: checked and timed, not summed); "launches" is the count from the main
paths (phases 4, 6, 7 and 8). Then the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Any failed check raises and the
exit code is not 0. Without CUDA it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 3e-2          # max|diff| <= TOL * max|ref| (tests/test_attention.py:262,307)
BWD_TOL = 5e-2      # each gradient, the JAX gradient tests' (tests/test_attention.py:274-280)
LSE_TOL = 1e-2      # kernel 5's logsumexp, absolute, natural-log units
SEED = 0
# Phase 2 scales kernels 1 and 2's Wq and Wk by this, so the logits are
# ~N(0, 9) instead of ~N(0, 1): a peaked softmax whose output is O(1). With
# near-uniform weights over L = 9216 keys the attention term is ~0.02 and
# hides under one bf16 ulp of the residual it is added to. Kernel 5 adds no
# residual and keeps ~N(0, 1) logits, so its bf16-rounded q (scale and
# log2(e) folded in, as on the TPU) keeps its lse within LSE_TOL.
SHARPEN = math.sqrt(3.0)
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FLOPS = 989e12   # bf16 tensor cores
PEAK_BYTES = 3.35e12  # HBM3
# Kernel sites of one UNet forward (batch 2, 16 frames) per configuration;
# inference launches no backward kernel
NO_BWD = {"flash_attention_bwd": 0, "temporal_attn_bwd": 0, "geglu_ff_bwd": 0}
SITES = {
    "mdm512": {"spatial_attn": 10, "temporal_attn": 11, "geglu_ff": 33, "gn_silu_tconv": 20,
               "flash_attention": 0, **NO_BWD},
    "mdm1024": {"spatial_attn": 10, "temporal_attn": 11, "geglu_ff": 33, "gn_silu_tconv": 20,
                "flash_attention": 5, **NO_BWD},
}
LATENT = {"mdm512": (40, 64), "mdm1024": (72, 128)}
# Kernel sites of one training micro-step (batch 1, 16 frames) under the JAX
# training dispatch (tests/test_torch_train.py holds them against the JAX
# predicates): kernel 5/6 at the spatial self-attention with L >= 512,
# kernels 2/9 where `bwd_eligible` holds (C <= 512: ds1 and init_attn),
# kernels 3/10 where `ff_bwd_eligible` and the FF kernel's m % 256 hold (the
# MDM512 middle block, m = 640, does not). Each backward kernel runs once per
# site; under remat the forward kernels run again in the backward except at
# init_attn, which is not checkpointed.
TRAIN_SITES = {"mdm512": {"flash_attention": 10, "temporal_attn": 6, "geglu_ff": 31},
               "mdm1024": {"flash_attention": 15, "temporal_attn": 6, "geglu_ff": 33}}
INIT_ATTN_SITES = {"temporal_attn": 1, "geglu_ff": 1}
TRAIN_FRAMES = 16   # batch 1 x 16 frames
KERNEL_ROWS = {
    "spatial_attn": ("mudg_tpu_torch/csrc/spatial_attn.cu",
                     "mudg_tpu/kernels/spatial_attn.py:163,365,550"),
    "temporal_attn": ("mudg_tpu_torch/csrc/temporal_attn.cu",
                      "mudg_tpu/kernels/temporal_attn.py:205"),
    "geglu_ff": ("mudg_tpu_torch/csrc/mlp.cu", "mudg_tpu/kernels/mlp.py:235"),
    "gn_silu_tconv": ("mudg_tpu_torch/csrc/tconv.cu", "mudg_tpu/kernels/tconv.py:128"),
    "flash_attention": ("mudg_tpu_torch/csrc/flash_attn.cu",
                        "mudg_tpu/kernels/flash_attention.py:132,159"),
    "flash_attention_bwd": ("mudg_tpu_torch/csrc/flash_attn_bwd.cu",
                            "mudg_tpu/kernels/flash_attention.py:396,412,315,331"),
    "temporal_attn_bwd": ("mudg_tpu_torch/csrc/temporal_attn_bwd.cu",
                          "mudg_tpu/kernels/temporal_attn.py:406"),
    "geglu_ff_bwd": ("mudg_tpu_torch/csrc/mlp_bwd.cu", "mudg_tpu/kernels/mlp.py:438"),
}


def train_launches(cfg, micro_steps):
    """Every kernel's launches in `micro_steps` training micro-steps with remat."""
    sites = TRAIN_SITES[cfg]
    fwd = {k: 2 * v - INIT_ATTN_SITES.get(k, 0) for k, v in sites.items()}
    counts = {"spatial_attn": 0, "gn_silu_tconv": 0, **fwd,
              **{k + "_bwd": v for k, v in sites.items()}}
    return {k: micro_steps * v for k, v in counts.items()}


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters=10, warmup=2):
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    ev = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) for a, b in ev)
    return ts[len(ts) // 2]


def bound(flops, nbytes):
    """(ms, "bytes" | "operations"): the least time the card could take for
    `flops` bf16 operations and `nbytes` bytes moved."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def work_flash(b, l, h, d):
    return 4 * b * h * l * l * d, 4 * 2 * b * l * h * d + 4 * b * h * l


# The backward functions: their inputs include the fp32 parameters (read once)
# and their outputs the fp32 weight gradients (written once).
def work_flash_bwd(b, l, h, d):
    """Five L x L x d products per (batch, head); q, k, v, o, dO in, dq, dk,
    dv out (bf16), lse in (fp32)."""
    return 10 * b * h * l * l * d, 2 * 8 * b * l * h * d + 4 * b * h * l


def work_temporal_bwd(rows, c):
    """Both stages: per stage 11 C x C products per row (q|k|v, dO, dW q|k|v,
    dWo, dLN(x)) and 6 per row and head over 16 keys; tokens, h1, dy in and
    dx out (bf16); two stages' 4C^2 + 3C parameters in and gradients out."""
    return (4 * rows * c * (11 * c + 96),
            2 * 4 * rows * c + 2 * 2 * 4 * (4 * c * c + 3 * c))


def work_ff_bwd(m, c):
    """8 M x C x inner multiply-adds (u, g, dh, dx, dW2, dW1); x, dy in, dx out
    (bf16); W1, b1, W2 in and their and b2's gradients out (fp32)."""
    inner = 4 * c
    return 16 * m * c * inner, 2 * 3 * m * c + 4 * (6 * c * inner + 4 * inner + c)


def randomize_(torch, module, gen):
    """Re-randomize EVERY parameter (the zero-initialised output projections
    would otherwise hide kernel errors): matrices N(0, 1/fan_in), norm
    scales 1 + 0.1 N(0, 1), biases and other vectors 0.1 N(0, 1)."""
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            r = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
            if p.ndim >= 2:
                r *= 1.0 / math.sqrt(p[0].numel())
            elif name.endswith("weight"):
                r = 1.0 + 0.1 * r
            else:
                r *= 0.1
            p.copy_(r)
    return module


def phase_build(torch, _build):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    build_log = _build.BUILD_DIR / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                log("  ptxas: " + line.strip())
    return card


class Case(NamedTuple):
    """One kernel shape of a UNet forward. `base` is the residual input the
    kernel adds to its output (None where it adds none): the check holds
    output - base, so the part the kernel computes is not hidden under the
    rounding of the residual. `faults` are plain versions with a planted
    fault (name -> fn); the check must see each of them."""
    name: str
    config: str
    label: str
    sites: int
    work: tuple
    kernel: Callable
    plain: Callable
    library: Callable | None
    base: object
    faults: dict
    grads: bool = False   # kernel and plain return tuples of gradients


def sharpen_(attn):
    import torch

    with torch.no_grad():
        attn.to_q.weight.mul_(SHARPEN)
        attn.to_k.weight.mul_(SHARPEN)
    return attn


def zero_v(attn):
    """A copy of `attn` whose value projection is zero: its attention term is
    0, as from a kernel that writes no attention."""
    import torch

    z = copy.deepcopy(attn)
    with torch.no_grad():
        z.to_v.weight.zero_()
    return z


def half_keys_self_attention(x, norm, attn, heads):
    """Kernel 1's function with each query attending to the first half of the
    frame's keys only, as from a kernel that walks half its K/V tiles."""
    from mudg_tpu_torch.nn import attention as A
    from mudg_tpu_torch.nn import functional as F

    h = F.layer_norm(norm, x)
    q, k, v = (A._split_heads(F.linear(m, h), heads) for m in (attn.to_q, attn.to_k, attn.to_v))
    half = x.shape[1] // 2
    o = A.plain_attend(q, k[:, :half], v[:, :half])
    return F.linear(attn.to_out["0"], A._merge_heads(o)) + x


def kernel_cases(torch, K, nn_att, configs, dev="cuda", latent=None):
    """Yield a Case for every kernel shape of a UNet forward at each
    configuration; inputs are made when the case is reached. `latent` maps a
    configuration to its (h, w) (default LATENT)."""
    from torch import nn

    latent = latent or LATENT
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf)

    def mods(*ms):
        return [randomize_(torch, m.to(dev, bf), gen) for m in ms]

    def norm_attention(c):
        norm, attn = mods(nn.LayerNorm(c), nn_att.CrossAttention(c, heads=c // 64, dim_head=64))
        return norm, sharpen_(attn)

    for cfg in configs:
        h, w = latent[cfg]
        tok = [h * w, h * w // 4, h * w // 16, h * w // 64]     # ds1, ds2, ds4, ds8
        for l, c, label in ((tok[0], 320, "ds1"), (tok[1], 640, "ds2")):
            heads = c // 64
            norm, attn = norm_attention(c)
            pk = K.spatial_attn.pack_stage(norm, attn, heads)
            x = rand(32, l, c)
            yield Case("spatial_attn", cfg, f"{label} 32x{l}x{c}", 5, work_spatial(32, l, c),
                       lambda: K.spatial_attn.fused_self_attention(x, norm, attn, heads, pk),
                       lambda: K.spatial_attn.plain_self_attention(x, norm, attn, heads), None,
                       x, {"zero attention": lambda: K.spatial_attn.plain_self_attention(
                               x, norm, zero_v(attn), heads),
                           "half the keys": lambda: half_keys_self_attention(
                               x, norm, attn, heads)})
        for n_seq, c, sites, label in ((2 * tok[0], 320, 5, "ds1"), (2 * tok[0], 512, 1, "init_attn"),
                                       (2 * tok[1], 640, 5, "ds2")):
            heads = c // 64
            (n1, a1), (n2, a2) = norm_attention(c), norm_attention(c)
            pk = (K.spatial_attn.pack_stage(n1, a1, heads), K.spatial_attn.pack_stage(n2, a2, heads))
            x = rand(n_seq, 16, c)
            yield Case("temporal_attn", cfg, f"{label} {n_seq * 16}x{c}", sites,
                       work_temporal(n_seq, 16, c),
                       lambda: K.temporal_attn.fused_double_self_attn(x, (n1, a1), (n2, a2), heads, pk),
                       lambda: K.temporal_attn.plain_double_self_attn(x, (n1, a1), (n2, a2), heads),
                       None, x,
                       {"zero attention": lambda: K.temporal_attn.plain_double_self_attn(
                           x, (n1, zero_v(a1)), (n2, zero_v(a2)), heads)})
        for m, c, block, sites in ((32 * tok[0], 320, True, 10), (32 * tok[0], 512, True, 1),
                                   (32 * tok[1], 640, False, 10), (32 * tok[2], 1280, False, 10),
                                   (32 * tok[3], 1280, False, 2)):
            norm, ff = mods(nn.LayerNorm(c), nn_att.FeedForward(c))
            pk = K.mlp.pack_ff(ff, norm)
            x = rand(m, c)
            if block:
                fk = lambda: K.mlp.fused_geglu_ff_block(x, norm, ff, pk)   # noqa: E731
                fp = lambda: K.mlp.plain_geglu_ff_block(x, norm, ff)       # noqa: E731
            else:
                fk = lambda: K.mlp.fused_geglu_ff(x, ff, pk)               # noqa: E731
                fp = lambda: K.mlp.plain_geglu_ff(x, ff)                   # noqa: E731
            yield Case("geglu_ff", cfg, f"{'block' if block else 'bare'} {m}x{c}", sites,
                       work_ff(m, c, block), fk, fp, None, x if block else None, {})
        norm, conv = mods(nn.GroupNorm(32, 320), nn.Conv3d(320, 320, (3, 1, 1)))
        pk = K.tconv.pack_tconv(conv)
        x = rand(2, 16, h, w, 320)
        yield Case("gn_silu_tconv", cfg, f"ds1 2x16x{h}x{w}x320", 20, work_tconv(2, 16, h, w, 320),
                   lambda: K.tconv.fused_gn_silu_tconv(x, norm, conv, pk),
                   lambda: K.tconv.plain_gn_silu_tconv(x, norm, conv), None, None, {})
        if cfg == "mdm1024":
            # ds4 self-attention (C=1280, 20 heads, L=576) and one long shape
            # that streams 144 K/V tiles per query tile
            for b, l, heads, sites, label in ((32, tok[2], 20, 5, "ds4"), (2, tok[0], 5, 0, "long")):
                qkv = rand(b, l, 3, heads, 64)
                q, k, v = qkv.unbind(2)
                yield Case("flash_attention", cfg, f"{label} {b}x{l}x{heads}x64", sites,
                           work_flash(b, l, heads, 64),
                           lambda: K.flash_attention.flash_attention(q, k, v),
                           lambda: K.flash_attention.plain_flash_attention(q, k, v),
                           lambda: torch.nn.functional.scaled_dot_product_attention(
                               q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
                           None, {"half the keys": lambda: nn_att.plain_attend(
                               q, k[:, :l // 2], v[:, :l // 2], with_lse=True)})


def sdpa_backward(torch, q, k, v, do):
    """The backward of torch's scaled_dot_product_attention under autograd
    on the same inputs, as a timed yardstick (its forward runs once, at the
    first call)."""
    state = {}

    def run():
        if not state:
            with torch.enable_grad():
                ts = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
                state["out"] = torch.nn.functional.scaled_dot_product_attention(*ts)
            state["ts"] = ts
        return torch.autograd.grad(state["out"], state["ts"], do.transpose(1, 2),
                                   retain_graph=True)
    return run


def half_keys_flash_bwd(torch, K, q, k, v, o, lse, do):
    """Kernel 6's function walking the first half of the K/V tiles only,
    with the second half's dk and dv left zero."""
    half = q.shape[1] // 2
    dq, dk, dv = K.flash_attention.plain_flash_attention_bwd(q, k[:, :half], v[:, :half], o,
                                                           lse, do)
    pad = (0, 0, 0, 0, 0, q.shape[1] - half)
    return dq, torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad)


def grad_cases(torch, K, nn_att, dev="cuda", latent=None):
    """Yield a Case for every backward-kernel shape of a training micro-step
    (batch 1, 16 frames): kernel 6 at the MDM512 and MDM1024 training
    lengths, each after kernel 5 at the same shape, and kernels 9 and 10
    at every MDM512 and MDM1024 training site, with fp32 parameters (the
    training masters) and bf16 activations.
    `latent` maps a configuration to its (h, w) (default LATENT)."""
    from torch import nn

    latent = latent or LATENT
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    FA, TA, M = K.flash_attention, K.temporal_attn, K.mlp

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(bf)

    def mods(*ms):
        return [randomize_(torch, m.to(dev), gen) for m in ms]

    def flat(out):
        dx, *rest = out
        return (dx, *[g for gs in rest for g in (gs if isinstance(gs, tuple) else (gs,))])

    for cfg, labels in (("mdm512", ("ds1", "ds2")), ("mdm1024", ("ds1", "ds2", "ds4"))):
        h, w = latent[cfg]
        for label in labels:
            i = ("ds1", "ds2", "ds4").index(label)
            l, heads = h * w // 4 ** i, 5 * 2 ** i
            qkv = rand(TRAIN_FRAMES, l, 3, heads, 64)
            q0, k0, v = qkv.unbind(2)
            # kernel 5 at the training shape (~N(0, 1) logits, as in its
            # forward cases); sites 0: checked and timed, not in the sums
            yield Case("flash_attention", cfg, f"train {label} {TRAIN_FRAMES}x{l}x{heads}x64", 0,
                       work_flash(TRAIN_FRAMES, l, heads, 64),
                       lambda: FA.flash_attention(q0, k0, v),
                       lambda: FA.plain_flash_attention(q0, k0, v),
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           q0.transpose(1, 2), k0.transpose(1, 2), v.transpose(1, 2)),
                       None, {"half the keys": lambda: nn_att.plain_attend(
                           q0, k0[:, :l // 2], v[:, :l // 2], with_lse=True)})
            q, k = q0 * SHARPEN, k0 * SHARPEN   # peaked logits
            o, lse = FA.plain_flash_attention(q, k, v)
            do = rand(TRAIN_FRAMES, l, heads, 64)
            zero = torch.zeros_like(lse)
            yield Case("flash_attention_bwd", cfg, f"{label} {TRAIN_FRAMES}x{l}x{heads}x64", 5,
                       work_flash_bwd(TRAIN_FRAMES, l, heads, 64),
                       lambda: FA.flash_attention_bwd(q, k, v, o, lse, do),
                       lambda: FA.plain_flash_attention_bwd(q, k, v, o, lse, do),
                       sdpa_backward(torch, q, k, v, do), None,
                       {"delta dropped": lambda: FA.plain_flash_attention_bwd(
                           q, k, v, o, lse, do, delta=zero),
                        "half the keys": lambda: half_keys_flash_bwd(torch, K, q, k, v, o, lse,
                                                                      do)},
                       grads=True)

    for cfg in ("mdm512", "mdm1024"):
        h, w = latent[cfg]
        n_seq = h * w
        for c, sites, label in ((320, 5, "ds1"), (512, 1, "init_attn")):
            heads = c // 64
            n1, a1, n2, a2 = mods(nn.LayerNorm(c), nn_att.CrossAttention(c, heads=heads),
                                  nn.LayerNorm(c), nn_att.CrossAttention(c, heads=heads))
            sharpen_(a1), sharpen_(a2)
            p1, p2 = TA.stage_params(n1, a1), TA.stage_params(n2, a2)
            x = rand(n_seq, 16, c)
            h1 = TA.plain_stage(x, p1, heads)
            dy = rand(n_seq, 16, c)

            def faulty(x=x, h1=h1, dy=dy, p1=p1, p2=p2, heads=heads):
                dh1, g2 = TA.plain_temporal_stage_bwd(h1, dy, p2, heads, drop_rowsum=True)
                dx, g1 = TA.plain_temporal_stage_bwd(x, dh1, p1, heads, drop_rowsum=True)
                return flat((dx, g1, g2))

            yield Case("temporal_attn_bwd", cfg, f"{label} {n_seq * 16}x{c}", sites,
                       work_temporal_bwd(n_seq * 16, c),
                       lambda: flat(TA.double_self_attn_bwd(x, h1, dy, p1, p2, heads)),
                       lambda: flat(_plain_double_bwd(TA, x, h1, dy, p1, p2, heads)),
                       None, None, {"row-sum term dropped": faulty}, grads=True)

        # (rows, C, sites): ds1, init_attn, ds2, ds4 and, at MDM1024 only,
        # the middle block (MDM512's has 640 rows, not a multiple of 256)
        tok = [16 * h * w // 4 ** i for i in range(4)]
        shapes = [(tok[0], 320, 10), (tok[0], 512, 1), (tok[1], 640, 10), (tok[2], 1280, 10)]
        if cfg == "mdm1024":
            shapes.append((tok[3], 1280, 2))
        for m, c, sites in shapes:
            (ff,) = mods(nn_att.FeedForward(c))
            w1, b1, w2, _ = M.ff_params(ff)
            x, dy = rand(m, c), rand(m, c)
            yield Case("geglu_ff_bwd", cfg, f"{m}x{c}", sites, work_ff_bwd(m, c),
                       lambda: M.geglu_ff_bwd(x, dy, w1, b1, w2),
                       lambda: M.plain_geglu_ff_bwd(x, dy, w1, b1, w2), None, None,
                       {"g pdf(g) term dropped": lambda: M.plain_geglu_ff_bwd(
                           x, dy, w1, b1, w2, drop_pdf_term=True)}, grads=True)


def _plain_double_bwd(TA, x, h1, dy, p1, p2, heads):
    dh1, g2 = TA.plain_temporal_stage_bwd(h1, dy, p2, heads)
    dx, g1 = TA.plain_temporal_stage_bwd(x, dh1, p1, heads)
    return dx, g1, g2


class Check(NamedTuple):
    ok: bool
    err: float           # max|diff| of the kernel's part against the plain version's
    scale: float         # max|plain version's part|
    lse_err: float | None
    faults: dict         # planted fault -> its max|diff| against the plain version
    tol: float = TOL     # the check is err <= tol * scale
    abs_err: float = 0.0   # max|diff| over every output


def compare_grads(torch, case):
    """A backward kernel against its plain version: each gradient within
    max|diff| <= BWD_TOL * max|its ref|. err is the largest such ratio
    (scale 1), a planted fault's the largest ratio over its gradients; each
    fault must pass BWD_TOL on some gradient."""
    got = case.kernel()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    ref = case.plain()

    def ratios(out):
        diffs = [(o.float() - r.float()).abs().max().item() for o, r in zip(out, ref)]
        return [d / max(r.float().abs().max().item(), 1e-30) for d, r in zip(diffs, ref)], diffs

    rel, diffs = ratios(got)
    ok = all(bool(torch.isfinite(g).all().item()) for g in got) and max(rel) <= BWD_TOL
    del got
    faults = {}
    for name, fn in case.faults.items():
        faults[name] = max(ratios(fn())[0])
        ok &= faults[name] > BWD_TOL
    return Check(ok, max(rel), 1.0, None, faults, BWD_TOL, max(diffs))


def compare(torch, case):
    """The kernel against its plain version on one case: max|diff| <= TOL *
    max|ref| on output - base, kernel 5's lse within LSE_TOL, and every
    planted fault beyond TOL * max|ref| (else the check could not see it)."""
    if case.grads:
        return compare_grads(torch, case)

    def part(out):
        o = (out[0] if isinstance(out, tuple) else out).float()
        return o - case.base.float() if case.base is not None else o

    got = case.kernel()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    ref = case.plain()
    go, ro = part(got), part(ref)
    err = (go - ro).abs().max().item()
    scale = ro.abs().max().item()
    ok = bool(torch.isfinite(go).all().item()) and err <= TOL * scale
    lse_err = None
    if isinstance(got, tuple):
        lse_err = (got[1] - ref[1]).abs().max().item()
        ok &= lse_err <= LSE_TOL
    del got, go
    faults = {}
    for name, fn in case.faults.items():
        faults[name] = (part(fn()) - ro).abs().max().item()
        ok &= faults[name] > TOL * scale
    return Check(ok, err, scale, lse_err, faults, TOL, err)


def phase_kernels(torch, K, nn_att, configs):
    """Each kernel vs its plain version at every shape of `configs`, then
    each backward kernel at every training shape."""
    import itertools

    rows = {}
    cases = itertools.chain(kernel_cases(torch, K, nn_att, configs),
                            grad_cases(torch, K, nn_att))
    for case in cases:
        chk = compare(torch, case)
        fk, fp, flib = case.kernel, case.plain, case.library
        reps = dict(iters=3, warmup=1) if case.grads else {}
        ms, pms = cuda_ms(torch, fk, **reps), cuda_ms(torch, fp, **reps)
        lms = cuda_ms(torch, flib, **reps) if flib is not None else None
        flops, nbytes = case.work
        bms, by = bound(flops, nbytes)
        extra = f", lse max|diff| {chk.lse_err:.3e} <= {LSE_TOL}" if chk.lse_err is not None else ""
        extra += "".join(f", {n} {e:.3e}" for n, e in chk.faults.items())
        what = ("max|diff|/max|ref| over the gradients" if case.grads else
                f"max|diff|{' - x' if case.base is not None else ''}")
        log(f"  {case.name:19s} {case.config:7s} {case.label:26s} "
            f"{what} {chk.err:.4e} <= {chk.tol} * "
            f"{chk.scale:.3e}{extra}: {'ok' if chk.ok else 'FAIL'}   kernel {ms:.3f} ms   "
            f"plain {pms:.3f} ms" + (f"   library {lms:.3f} ms" if lms is not None else "")
            + f"   bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f}% of it)")
        r = rows.setdefault(case.name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                        "bound_ms": 0.0, "library_ms": None, "ok": True,
                                        "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], chk.abs_err)
        r["ms"] += case.sites * ms
        r["plain_ms"] += case.sites * pms
        r["bound_ms"] += case.sites * bms
        if lms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + case.sites * lms
        r["ok"] &= chk.ok
        r["shapes"].append({"config": case.config, "shape": case.label, "sites": case.sites,
                            "max_abs_err": chk.abs_err, "err": chk.err, "tol": chk.tol,
                            "max_abs_ref": chk.scale,
                            "residual_free": case.base is not None, "lse_err": chk.lse_err,
                            "fault_errs": chk.faults, "ms": ms, "plain_ms": pms,
                            "library_ms": lms, "bound_ms": bms, "bound_by": by,
                            "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
        del case, fk, fp, flib
        torch.cuda.empty_cache()
    for r in rows.values():   # what bounds most of the row's forward-weighted bound
        top = max(r["shapes"], key=lambda s: (s["sites"] * s["bound_ms"], s["bound_ms"]))
        r["bound_by"] = top["bound_by"]
    bad = [n for n, r in rows.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return rows


def build_unet(torch, U, gen, dtype):
    with torch.device("meta"):
        unet = U.UNet3D(U.UNetConfig())
    unet.to_empty(device="cuda")
    randomize_(torch, unet, gen)
    return unet.to(dtype).eval()


def unet_inputs(torch, gen, dtype, cfg):
    h, w = LATENT[cfg]

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device="cuda") * scale).to(dtype)
    x = rnd(2, 16, h, w, 12)
    t = torch.tensor([700, 700], device="cuda")
    ctx = rnd(2, 77 + 16 * 16, 1024)
    lab = torch.zeros(2, dtype=torch.int64, device="cuda")
    fs = torch.full((2,), 10, dtype=torch.int64, device="cuda")
    return x, t, ctx, lab, fs


def phase_unet(torch, K, U, cfg):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    unet = build_unet(torch, U, gen, torch.float32)
    n_params = sum(p.numel() for p in unet.parameters())
    x, t, ctx, lab, fs = unet_inputs(torch, gen, torch.float32, cfg)
    with torch.no_grad():
        ref = unet(x, t, ctx, c_label=lab, fs=fs, impl="plain")
        unet.to(torch.bfloat16)
        K.prepare_kernels(unet)
        xb, cb = x.bfloat16(), ctx.bfloat16()
        del x, ctx

        def run(impl):
            return unet(xb, t, cb, c_label=lab, fs=fs, impl=impl)

        plain = run("plain")
        K.reset_launch_counts()
        kern = run("auto")
        counts = K.launch_counts()
        ms_k = cuda_ms(torch, lambda: run("auto"), iters=3, warmup=1)
        ms_p = cuda_ms(torch, lambda: run("plain"), iters=3, warmup=1)

    def rel(a):
        return ((a.float() - ref).norm() / ref.norm()).item()

    e_k, e_p = rel(kern), rel(plain)
    err_bound = 1.5 * e_p + 5e-3
    log(f"  UNet {n_params:,} params, out {tuple(kern.shape)}")
    log(f"  rel L2 vs fp32: kernels {e_k:.4e}, plain bf16 {e_p:.4e}, bound {err_bound:.4e}")
    log(f"  launches per forward: {counts} (expected {SITES[cfg]})")
    log(f"  forward bf16: kernels {ms_k:.1f} ms, plain {ms_p:.1f} ms")
    if not bool(torch.isfinite(kern).all().item()):
        raise AssertionError("kernel-path UNet output is not finite")
    if e_k > err_bound:
        raise AssertionError(f"kernel-path error {e_k:.4e} exceeds {err_bound:.4e}")
    if counts != SITES[cfg]:
        raise AssertionError(f"launch counts {counts} != {SITES[cfg]}")
    del ref, plain, kern
    return unet, {"params": n_params, "rel_l2_kernels": e_k, "rel_l2_plain_bf16": e_p,
                  "ms_kernels": ms_k, "ms_plain": ms_p}


CATEGORIES = (("port kernels", ("mudg::",)),
              ("conv (cuDNN)", ("fprop", "conv", "implicit")),
              ("gemm (cuBLAS)", ("gemm", "nvjet", "cutlass")),
              ("softmax", ("softmax",)),
              ("reductions", ("reduce",)),
              ("elementwise / copy", ("elementwise", "copy", "cat", "index")))


def profile_call(torch, fn, label):
    """torch.profiler over one call of fn (after one unprofiled call): device
    time by kernel and by kind, and the device's busy time against the
    call's wall time (both under the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: CPU-side ops also carry their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    kinds = {}
    for e in events:
        kind = next((k for k, keys in CATEGORIES
                     if any(s in e.key.lower() or s in e.key for s in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    log(f"  profile {label}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"wall (idle {100 * (1 - busy_ms / wall_ms):.1f}%, under the profiler)")
    log("    by kind: " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                    sorted(kinds.items(), key=lambda kv: -kv[1])))
    top = [{"name": e.key[:100], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
           for e in events[:40]]
    for r in top[:12]:
        log(f"    {r['device_ms']:8.2f} ms  {r['calls']:5d}x  {r['name']}")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "kinds": kinds, "top": top}


def save_profile(result, name, out_dir):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{name}.json"), "w") as f:
            json.dump(result, f, indent=1)


def phase_profile(torch, unet, cfg, out_dir):
    """One UNet forward per path under the profiler."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x, t, ctx, lab, fs = unet_inputs(torch, gen, torch.bfloat16, cfg)
    result = {}
    for impl in ("auto", "plain"):
        with torch.no_grad():
            result[impl] = profile_call(
                torch, lambda: unet(x, t, ctx, c_label=lab, fs=fs, impl=impl),
                f"{cfg} impl={impl}")
    save_profile(result, cfg, out_dir)
    return result


def host_s(torch, fn):
    """Host-clock seconds of one synchronized call of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def check_clip(torch, out, shape, counts, expect):
    if tuple(out.shape) != shape:
        raise AssertionError(f"clip shape {tuple(out.shape)} != {shape}")
    if not bool(torch.isfinite(out).all().item()):
        raise AssertionError("clip is not finite")
    if out.min().item() < -1.0 or out.max().item() > 1.0:
        raise AssertionError("clip outside [-1, 1]")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")


def warm_up(torch, unet, gen, cfg):
    """One UNet call at the clip's batch and latent size."""
    with torch.no_grad():
        x, t, ctx, lab, fs = unet_inputs(torch, gen, torch.bfloat16, cfg)
        unet(x, t, ctx, c_label=lab, fs=fs)
    torch.cuda.synchronize()


def phase_clip(torch, K, U, mdm_mod, unet):
    cfg = mdm_mod.MDMConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    if unet is None:
        unet = build_unet(torch, U, gen, torch.bfloat16)
        K.prepare_kernels(unet)
    with torch.device("meta"):
        mdm = mdm_mod.MDM(cfg)
    mdm.unet = unet
    mdm.vae.to_empty(device="cuda")
    randomize_(torch, mdm.vae, gen).to(torch.bfloat16).eval()

    bf = torch.bfloat16
    h, w = LATENT["mdm512"]
    f = 2 ** (len(cfg.vae.ch_mult) - 1)
    c_concat = (torch.randn((1, 16, h, w, 8), generator=gen, device="cuda") * 0.5).to(bf)
    ctx_c = torch.randn((1, 77 + 256, 1024), generator=gen, device="cuda").to(bf)
    ctx_u = torch.randn((1, 77 + 256, 1024), generator=gen, device="cuda").to(bf)
    label = torch.zeros(1, dtype=torch.int64, device="cuda")
    warm_up(torch, unet, gen, "mdm512")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = mdm_mod.sample_clip(mdm, c_concat, ctx_c, ctx_u, label,
                              generator=torch.Generator(device="cuda").manual_seed(SEED + 3),
                              num_steps=25, guidance_scale=7.5, guidance_rescale=0.7,
                              eta=1.0, timestep_spacing="uniform_trailing", decode_chunk=16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    expect = {k: 25 * v for k, v in SITES["mdm512"].items()}
    log(f"  clip {tuple(out.shape)} {out.dtype}: {secs:.3f} s/clip, "
        f"range [{out.min().item():.3f}, {out.max().item():.3f}], std {out.std().item():.4f}")
    log(f"  launches in the clip: {counts} (expected {expect})")
    check_clip(torch, out, (1, 16, h * f, w * f, 3), counts, expect)
    return counts, {"s_per_clip": secs, "std": out.std().item()}


def phase_sample(torch, K, U, mdm_mod, presets, unet):
    """`sample` at the mdm1024 preset: pixels and token ids to the clip."""
    from mudg_tpu_torch.nn import vae as V

    cfg = presets.mdm1024()
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    if unet is None:
        unet = build_unet(torch, U, gen, bf)
        K.prepare_kernels(unet)
    with torch.device("meta"):
        mdm = mdm_mod.MDM(cfg)
    mdm.unet = unet
    for name in ("vae", "image_proj", "clip_text", "clip_image"):
        sub = getattr(mdm, name)
        sub.to_empty(device="cuda")
        randomize_(torch, sub, gen).to(bf).eval()
    n_params = {name: sum(p.numel() for p in getattr(mdm, name).parameters())
                for name in ("unet", "vae", "image_proj", "clip_text", "clip_image")}
    log(f"  parameters: {n_params}")

    # (1, 16, 576, 1024, 3): the latent size times the VAE's downsampling
    f = 2 ** (len(cfg.vae.ch_mult) - 1)
    shape = (1, cfg.unet.temporal_length, LATENT["mdm1024"][0] * f, LATENT["mdm1024"][1] * f, 3)

    def video():
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1).to(bf)

    sparse_frames, sparse_depth = video(), video()
    vocab = cfg.clip_text.vocab_size
    tokens = torch.randint(0, vocab, (1, 77), generator=gen, device="cuda")
    null_tokens = torch.randint(0, vocab, (77,), generator=gen, device="cuda")
    label = torch.zeros(1, dtype=torch.int64, device="cuda")
    warm_up(torch, unet, gen, "mdm1024")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = mdm_mod.sample(mdm, generator=torch.Generator(device="cuda").manual_seed(SEED + 6),
                         sparse_frames=sparse_frames, sparse_depth=sparse_depth, tokens=tokens,
                         null_tokens=null_tokens, class_label=label, num_steps=25,
                         guidance_scale=7.5, guidance_rescale=0.7, eta=1.0,
                         timestep_spacing="uniform_trailing", dtype=bf)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    expect = {k: 25 * v for k, v in SITES["mdm1024"].items()}
    log(f"  clip {tuple(out.shape)} {out.dtype}: {secs:.3f} s/clip, "
        f"range [{out.min().item():.3f}, {out.max().item():.3f}], std {out.std().item():.4f}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"  launches in the clip: {counts} (expected {expect})")
    check_clip(torch, out, shape, counts, expect)

    # the clip's stages outside the UNet, each timed alone after the clip
    img = sparse_frames[:, 0]
    z = torch.randn((1, shape[1], *LATENT["mdm1024"], cfg.unet.out_channels), generator=gen,
                    device="cuda").to(bf)
    stages = {
        "encode_text x2": host_s(torch, lambda: (mdm_mod.encode_text(mdm, tokens),
                                                 mdm_mod.encode_text(mdm, null_tokens[None]))),
        "embed_image (image + null)": host_s(
            torch, lambda: mdm_mod.embed_image(mdm, torch.cat([img, torch.zeros_like(img)]))),
        "encode_conditions": host_s(
            torch, lambda: mdm_mod.encode_conditions(mdm, sparse_frames, sparse_depth)),
        "decode": host_s(torch, lambda: V.decode_video(mdm.vae, z, chunk=cfg.vae_chunk)),
    }
    log("  stages alone: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
    return counts, {"s_per_clip": secs, "std": out.std().item(), "params": n_params,
                    "stages_s": stages}


def build_mdm(torch, mdm_mod, cfg, gen, dev="cuda"):
    """An MDM with all five sub-models random: the trainable UNet and
    resampler as fp32 masters, the frozen VAE and CLIP towers in bf16."""
    with torch.device("meta"):
        mdm = mdm_mod.MDM(cfg)
    for name in ("unet", "image_proj", "vae", "clip_text", "clip_image"):
        sub = getattr(mdm, name)
        sub.to_empty(device=dev)
        randomize_(torch, sub, gen)
        if name not in ("unet", "image_proj"):
            sub.to(torch.bfloat16)
    return mdm


def train_batch(torch, cfg, gen, hw, accum, dev="cuda"):
    """A pixel-form batch with a leading microbatch axis: seeded dense,
    sparse and depth videos (accum, 1, T, H, W, 3) in [-1, 1], token ids and
    a class label."""
    shape = (accum, 1, cfg.unet.temporal_length, *hw, 3)

    def video():
        return torch.rand(shape, generator=gen, device=dev) * 2 - 1

    return {"dense_frames": video(), "sparse_frames": video(), "sparse_depth": video(),
            "tokens": torch.randint(0, cfg.clip_text.vocab_size, (accum, 1, 77), generator=gen,
                                    device=dev),
            "class_label": torch.zeros((accum, 1), dtype=torch.int64, device=dev)}


def grad_check(torch, K, mdm_mod, mdm, batch, null_emb, gen):
    """One micro-step's trainable gradients, dropout off, from the same
    draws on three paths: kernels bf16 (impl "train"), plain bf16 and plain
    fp32 (TF32 off). Returns (relative L2 error of the kernel path and of
    the plain bf16 path against fp32, the kernel path's launch counts)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mdm.cfg
    mb = {k: v[0] for k, v in batch.items()}
    draws = mdm_mod.draw_training_noise(cfg, mdm_mod.training_shapes(cfg, mb), gen)
    params = [p for k in ("unet", "image_proj") for p in getattr(mdm, k).parameters()]

    def flat_grads(impl, dtype):
        for p in params:
            p.grad = None
        with torch.enable_grad():
            loss, _ = mdm_mod.training_loss(mdm, mb, draws, null_emb=null_emb, impl=impl,
                                            remat=True, compute_dtype=dtype)
            loss.backward()
        g = torch.cat([p.grad.reshape(-1) for p in params])
        for p in params:
            p.grad = None
        return g

    ref = flat_grads("plain", torch.float32)
    ref_norm = ref.norm()
    e_p = ((flat_grads("plain", torch.bfloat16) - ref).norm() / ref_norm).item()
    K.reset_launch_counts()
    e_k = ((flat_grads("train", torch.bfloat16) - ref).norm() / ref_norm).item()
    counts = K.launch_counts()
    return e_k, e_p, counts


def leaf_samples(params):
    """The first 64 elements of every leaf, copied, to see which moved."""
    return {n: p.detach().reshape(-1)[:64].clone() for n, p in params.items()}


def train_layers(torch, mdm_mod, step_mod, mdm, state, tc, mb, null_emb, gen):
    """One micro-batch's layers, each timed alone after the timed steps (host
    clock, synchronized): the frozen conditioning (the stacked VAE encode of
    the three videos, the text tower, the image tower and the resampler),
    `training_loss`'s forward alone, one micro-step (forward, remat
    recompute and backward) and the AdamW update of every trainable leaf.
    Returns (seconds by layer, the micro-step as a callable)."""
    from mudg_tpu_torch.nn import vae as V

    cfg = mdm.cfg
    bf = torch.bfloat16
    draws = mdm_mod.draw_training_noise(cfg, mdm_mod.training_shapes(cfg, mb), gen)
    videos = torch.cat([mb["dense_frames"], mb["sparse_frames"], mb["sparse_depth"]]).to(bf)

    def loss():
        return mdm_mod.training_loss(mdm, mb, draws, null_emb=null_emb, generator=gen)[0]

    def micro():
        for p in state.params.values():
            p.grad = None
        with torch.enable_grad():
            loss().backward()

    layers = {
        "VAE encode (3 videos)": host_s(torch, lambda: V.encode_moments_video(
            mdm.vae, videos, chunk=cfg.train_encode_chunk)),
        "text tower": host_s(torch, lambda: mdm_mod.encode_text(mdm, mb["tokens"])),
        "image tower + resampler": host_s(torch, lambda: mdm_mod.embed_image(
            mdm, mb["sparse_frames"][:, 0].to(bf))),
        "training_loss forward": host_s(torch, loss),
        "micro-step (forward + backward)": host_s(torch, micro),
    }
    grads = {n: p.grad for n, p in state.params.items()}
    opt = step_mod.AdamW(tc)
    layers["AdamW update"] = host_s(
        torch, lambda: opt.update(state, grads, step_mod.global_norm(grads.values())))
    for p in state.params.values():
        p.grad = None
    return layers, micro


def phase_train(torch, K, mdm_mod, step_mod, profile=False, out_dir=None):
    """Full-width MDM512 training: a gradient check, then a warm-up and
    three timed optimizer steps at batch 1, accumulation 2, remat, and the
    step's layers timed alone (with `profile`, one micro-step under the
    profiler)."""
    cfg = mdm_mod.MDMConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    mdm = build_mdm(torch, mdm_mod, cfg, gen)
    n_params = {k: sum(p.numel() for p in getattr(mdm, k).parameters())
                for k in ("unet", "image_proj", "vae", "clip_text", "clip_image")}
    f = 2 ** (len(cfg.vae.ch_mult) - 1)
    hw = tuple(n * f for n in LATENT["mdm512"])
    tc = step_mod.TrainConfig()
    batch = train_batch(torch, cfg, gen, hw, tc.accum_steps)
    null_tokens = torch.randint(0, cfg.clip_text.vocab_size, (77,), generator=gen, device="cuda")
    for k in step_mod.FROZEN:
        getattr(mdm, k).requires_grad_(False)
    null_emb = mdm_mod.encode_text(mdm, null_tokens[None])
    log(f"  parameters: {n_params}, batch {tuple(batch['dense_frames'].shape)}")

    e_k, e_p, counts = grad_check(torch, K, mdm_mod, mdm, batch, null_emb, gen)
    err_bound = 1.5 * e_p + 5e-3
    expect = train_launches("mdm512", 1)
    log(f"  one micro-step's UNet + resampler gradients, rel L2 vs fp32: kernels {e_k:.4e}, "
        f"plain bf16 {e_p:.4e}, bound {err_bound:.4e}")
    log(f"  launches in it: {counts} (expected {expect})")
    if not e_k <= err_bound:
        raise AssertionError(f"kernel-path gradient error {e_k:.4e} exceeds {err_bound:.4e}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    torch.cuda.empty_cache()

    state = step_mod.init_train_state(mdm, tc)
    step = step_mod.make_train_step(mdm, tc, null_tokens)
    torch.cuda.reset_peak_memory_stats()
    before = leaf_samples(state.params)
    state, m0 = step(state, batch, gen)   # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(3):
        state, m = step(state, batch, gen)
        metrics.append(m)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / 3
    counts = K.launch_counts()
    expect = train_launches("mdm512", 3 * tc.accum_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in [m0, *metrics]]
    norms = [float(m["grad_norm"]) for m in [m0, *metrics]]
    after = leaf_samples(state.params)
    still = [n for n in before if torch.equal(before[n], after[n])]
    log(f"  steps: {secs:.3f} s/step (host clock, 3 steps after a warm-up), peak memory "
        f"{peak:.1f} GiB; loss {losses}, grad norm {norms}")
    log(f"  launches in the 3 steps: {counts} (expected {expect})")
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError("loss or gradient norm not finite")
    if still:
        raise AssertionError(f"{len(still)} parameter leaves did not move, e.g. {still[:3]}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    layers, micro = train_layers(torch, mdm_mod, step_mod, mdm, state, tc,
                                 {k: v[0] for k, v in batch.items()}, null_emb, gen)
    log("  layers alone: " + ", ".join(f"{k} {v:.3f} s" for k, v in layers.items()))
    report = {"params": n_params, "rel_l2_grad_kernels": e_k, "rel_l2_grad_plain_bf16": e_p,
              "s_per_step": secs, "peak_gib": peak, "loss": losses, "grad_norm": norms,
              "layers_s": layers}
    if profile:
        report["profile"] = profile_call(torch, micro, "MDM512 training micro-step")
        save_profile(report["profile"], "train_mdm512", out_dir)
    del state, step, micro
    torch.cuda.empty_cache()
    return mdm, counts, report


def phase_train_stage2(torch, K, mdm_mod, step_mod, mdm):
    """One stage-2 optimizer step at MDM1024 (576x1024) with the temporal
    transformers frozen: they move by weight decay alone."""
    cfg = mdm_mod.stage2_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    if mdm is None:
        mdm = build_mdm(torch, mdm_mod, cfg, gen)
    else:   # the same five sub-models under the stage-2 configuration
        subs = {k: getattr(mdm, k) for k in ("unet", "image_proj", "vae", "clip_text",
                                              "clip_image")}
        with torch.device("meta"):
            mdm = mdm_mod.MDM(cfg)
        for k, sub in subs.items():
            setattr(mdm, k, sub)
    f = 2 ** (len(cfg.vae.ch_mult) - 1)
    hw = tuple(n * f for n in LATENT["mdm1024"])
    tc = step_mod.TrainConfig()
    batch = train_batch(torch, cfg, gen, hw, tc.accum_steps)
    null_tokens = torch.randint(0, cfg.clip_text.vocab_size, (77,), generator=gen, device="cuda")
    mask = {"unet." + n: v for n, v in step_mod.temporal_frozen_mask(mdm.unet).items()}
    frozen = [n for n, v in mask.items() if not v]
    state = step_mod.init_train_state(mdm, tc)
    step = step_mod.make_train_step(mdm, tc, null_tokens, grad_mask=mask)
    decayed = {n: state.params[n].detach().clone() for n in frozen}
    with torch.no_grad():   # what AdamW does to a leaf whose gradient is 0
        for n, p in decayed.items():
            p.sub_(tc.learning_rate * (tc.weight_decay * p))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    expect = train_launches("mdm1024", tc.accum_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    wrong = [n for n in frozen if not torch.equal(state.params[n], decayed[n])]
    log(f"  batch {tuple(batch['dense_frames'].shape)}: {secs:.3f} s for the step (no warm-up), "
        f"peak memory {peak:.1f} GiB, loss {loss:.5f}, grad norm {gnorm:.5f}")
    log(f"  {len(frozen)} frozen temporal leaves, {len(wrong)} moved by more than weight decay")
    log(f"  launches in the step: {counts} (expected {expect})")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError("loss or gradient norm not finite")
    if not frozen or wrong:
        raise AssertionError(f"frozen leaves moved by more than weight decay: {wrong[:3]}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    return counts, {"s_per_step_cold": secs, "peak_gib": peak, "loss": loss, "grad_norm": gnorm,
                    "frozen_leaves": len(frozen)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8")
    ap.add_argument("--out", default=None, help="directory for a JSON report")
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3 and 5, profile one UNet forward per path; in "
                         "phase 7, one training micro-step")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",") if p}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    # no autograd graph outside the training phases' own enable_grad blocks
    torch.set_grad_enabled(False)
    sys.path.insert(0, ROOT)
    try:
        import mudg_tpu_torch.kernels as K
        from mudg_tpu_torch.kernels import _build
        from mudg_tpu_torch.models import mdm as mdm_mod
        from mudg_tpu_torch.models import presets
        from mudg_tpu_torch.nn import attention as nn_att
        from mudg_tpu_torch.nn import unet3d as U
        from mudg_tpu_torch.train import step as step_mod
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}", file=sys.stderr)
        return 2

    report = {}
    t_all = time.perf_counter()

    def timed(n, title, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        log(f"phase {n} ({title}): {time.perf_counter() - t0:.1f} s")
        return r

    card = timed(1, "device, build", phase_build, torch, _build)
    rows = {}
    if 2 in phases:
        rows = timed(2, "kernels vs plain", phase_kernels, torch, K, nn_att,
                     ("mdm512", "mdm1024"))
    launches = {}
    unet = None
    if 3 in phases:
        unet, report["unet_mdm512"] = timed(3, "MDM512 UNet forward", phase_unet, torch, K, U,
                                            "mdm512")
        if args.profile:
            report["profile_mdm512"] = phase_profile(torch, unet, "mdm512", args.out)
    if 4 in phases:
        launches["mdm512_clip"], report["clip_mdm512"] = timed(
            4, "MDM512 25-step clip + decode", phase_clip, torch, K, U, mdm_mod, unet)
    del unet
    torch.cuda.empty_cache()
    unet = None
    if 5 in phases:
        unet, report["unet_mdm1024"] = timed(5, "MDM1024 UNet forward", phase_unet, torch, K, U,
                                             "mdm1024")
        if args.profile:
            report["profile_mdm1024"] = phase_profile(torch, unet, "mdm1024", args.out)
    if 6 in phases:
        launches["mdm1024_sample"], report["sample_mdm1024"] = timed(
            6, "MDM1024 sample", phase_sample, torch, K, U, mdm_mod, presets, unet)
    del unet
    torch.cuda.empty_cache()
    mdm = None
    if 7 in phases:
        mdm, launches["mdm512_train"], report["train_mdm512"] = timed(
            7, "MDM512 training", phase_train, torch, K, mdm_mod, step_mod, args.profile,
            args.out)
    if 8 in phases:
        launches["mdm1024_train"], report["train_mdm1024"] = timed(
            8, "MDM1024 stage-2 step", phase_train_stage2, torch, K, mdm_mod, step_mod, mdm)
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    for mod in list(sys.modules):
        if mod.split(".")[0] in ("jax", "jaxlib", "mudg_tpu"):
            raise AssertionError(f"{mod} was imported")

    table = {"kernels": []}
    for name in K.KERNELS:
        r = rows.get(name, {})
        table["kernels"].append({
            "name": name, "route": "cuda", "source": KERNEL_ROWS[name][0],
            "replaces": KERNEL_ROWS[name][1],
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            **{k: r.get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
            "shapes": r.get("shapes", [])})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "table": table, **report}, f, indent=1)
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
