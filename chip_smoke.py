#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mudg_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2,3,4,5,6] [--out DIR] [--profile]

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
     for the same work (bytes or operations at its peaks);
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
     then each stage of the clip outside the UNet timed alone (host clock).
It prints the kernel table as one JSON line: "ms", "plain_ms", "bound_ms" and
"library_ms" are one UNet forward's worth of the kernel at each of the two
configurations, summed (phase 2's per-call medians or bounds times the
sites per forward); "launches" is the count from the two main paths (phases
4 and 6). Then the card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Any failed check raises and the exit code is
not 0. Without CUDA it exits 2 and prints no result.
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
# Kernel sites of one UNet forward (batch 2, 16 frames) per configuration
SITES = {
    "mdm512": {"spatial_attn": 10, "temporal_attn": 11, "geglu_ff": 33, "gn_silu_tconv": 20,
               "flash_attention": 0},
    "mdm1024": {"spatial_attn": 10, "temporal_attn": 11, "geglu_ff": 33, "gn_silu_tconv": 20,
                "flash_attention": 5},
}
LATENT = {"mdm512": (40, 64), "mdm1024": (72, 128)}
KERNEL_ROWS = {
    "spatial_attn": ("mudg_tpu_torch/csrc/spatial_attn.cu",
                     "mudg_tpu/kernels/spatial_attn.py:163,365,550"),
    "temporal_attn": ("mudg_tpu_torch/csrc/temporal_attn.cu",
                      "mudg_tpu/kernels/temporal_attn.py:205"),
    "geglu_ff": ("mudg_tpu_torch/csrc/mlp.cu", "mudg_tpu/kernels/mlp.py:235"),
    "gn_silu_tconv": ("mudg_tpu_torch/csrc/tconv.cu", "mudg_tpu/kernels/tconv.py:128"),
    "flash_attention": ("mudg_tpu_torch/csrc/flash_attn.cu",
                        "mudg_tpu/kernels/flash_attention.py:132,159"),
}


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


class Check(NamedTuple):
    ok: bool
    err: float           # max|diff| of the kernel's part against the plain version's
    scale: float         # max|plain version's part|
    lse_err: float | None
    faults: dict         # planted fault -> its max|diff| against the plain version


def compare(torch, case):
    """The kernel against its plain version on one case: max|diff| <= TOL *
    max|ref| on output - base, kernel 5's lse within LSE_TOL, and every
    planted fault beyond TOL * max|ref| (else the check could not see it)."""
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
    return Check(ok, err, scale, lse_err, faults)


def phase_kernels(torch, K, nn_att, configs):
    """Each kernel vs its plain version at every shape of `configs`."""
    rows = {}
    for case in kernel_cases(torch, K, nn_att, configs):
        chk = compare(torch, case)
        fk, fp, flib = case.kernel, case.plain, case.library
        ms, pms = cuda_ms(torch, fk), cuda_ms(torch, fp)
        lms = cuda_ms(torch, flib) if flib is not None else None
        flops, nbytes = case.work
        bms, by = bound(flops, nbytes)
        extra = f", lse max|diff| {chk.lse_err:.3e} <= {LSE_TOL}" if chk.lse_err is not None else ""
        extra += "".join(f", {n} {e:.3e}" for n, e in chk.faults.items())
        log(f"  {case.name:15s} {case.config:7s} {case.label:26s} "
            f"max|diff|{' - x' if case.base is not None else ''} {chk.err:.4e} <= {TOL} * "
            f"{chk.scale:.3e}{extra}: {'ok' if chk.ok else 'FAIL'}   kernel {ms:.3f} ms   "
            f"plain {pms:.3f} ms" + (f"   library {lms:.3f} ms" if lms is not None else "")
            + f"   bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f}% of it)")
        r = rows.setdefault(case.name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                        "bound_ms": 0.0, "library_ms": None, "ok": True,
                                        "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], chk.err)
        r["ms"] += case.sites * ms
        r["plain_ms"] += case.sites * pms
        r["bound_ms"] += case.sites * bms
        if lms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + case.sites * lms
        r["ok"] &= chk.ok
        r["shapes"].append({"config": case.config, "shape": case.label, "sites": case.sites,
                            "max_abs_err": chk.err, "max_abs_ref": chk.scale,
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


def phase_profile(torch, unet, cfg, out_dir):
    """torch.profiler over one UNet forward per path: device time by kernel
    and by kind, and the device's busy time against the forward's wall time
    (both under the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x, t, ctx, lab, fs = unet_inputs(torch, gen, torch.bfloat16, cfg)
    result = {}
    for impl in ("auto", "plain"):
        with torch.no_grad():
            unet(x, t, ctx, c_label=lab, fs=fs, impl=impl)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                unet(x, t, ctx, c_label=lab, fs=fs, impl=impl)
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
        log(f"  profile {cfg} impl={impl}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
            f"wall (idle {100 * (1 - busy_ms / wall_ms):.1f}%, under the profiler)")
        log("    by kind: " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                        sorted(kinds.items(), key=lambda kv: -kv[1])))
        top = [{"name": e.key[:100], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
               for e in events[:40]]
        for r in top[:12]:
            log(f"    {r['device_ms']:8.2f} ms  {r['calls']:5d}x  {r['name']}")
        result[impl] = {"busy_ms": busy_ms, "wall_ms": wall_ms, "kinds": kinds, "top": top}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{cfg}.json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


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
    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    img = sparse_frames[:, 0]
    z = torch.randn((1, shape[1], *LATENT["mdm1024"], cfg.unet.out_channels), generator=gen,
                    device="cuda").to(bf)
    stages = {
        "encode_text x2": host_s(lambda: (mdm_mod.encode_text(mdm, tokens),
                                          mdm_mod.encode_text(mdm, null_tokens[None]))),
        "embed_image (image + null)": host_s(
            lambda: mdm_mod.embed_image(mdm, torch.cat([img, torch.zeros_like(img)]))),
        "encode_conditions": host_s(
            lambda: mdm_mod.encode_conditions(mdm, sparse_frames, sparse_depth)),
        "decode": host_s(lambda: V.decode_video(mdm.vae, z, chunk=cfg.vae_chunk)),
    }
    log("  stages alone: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
    return counts, {"s_per_clip": secs, "std": out.std().item(), "params": n_params,
                    "stages_s": stages}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6")
    ap.add_argument("--out", default=None, help="directory for a JSON report")
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3 and 5, profile one UNet forward per path")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",") if p}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)   # inference only: no autograd graph anywhere
    sys.path.insert(0, ROOT)
    try:
        import mudg_tpu_torch.kernels as K
        from mudg_tpu_torch.kernels import _build
        from mudg_tpu_torch.models import mdm as mdm_mod
        from mudg_tpu_torch.models import presets
        from mudg_tpu_torch.nn import attention as nn_att
        from mudg_tpu_torch.nn import unet3d as U
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
