"""The serving driver: a warm `render`/`serve` model answering a stream of
3-task windows through the port's `render_windows`, as `serve` runs them.

Set-up builds the served model as `render_infer.build_server` does (the
MDM loaded in fp32, `prepare_serving_params` casting it to the compute
dtype and packing every kernel site's weights, `build_sampler`), with the
weights drawn from the seed instead of a checkpoint and token ids in place
of the tokenizer. Window 0 is a one-step sampler call at the cell's shapes
(it builds the kernels, warms every shape and seeds the carry). Then
windows run back to back through `render_windows` with the guided DDIM
sampler; the timed span is the longest run of whole windows that ends
within the run's seconds, at least one. A traced run times its span alike,
the profiler off, and then traces one more window: the per-layer metrics
read that window's trace, and those of the whole window (`mfu.serve`,
`device_idle.serve`, `host_ms.serve`) its work over the untraced span's
wall time, which the profiler's host cost would stretch.

A forward hook on the UNet keeps, at the steps the check reads, the noisy
latents the UNet was given and the predictions it returned; the check runs
after the span, on one timed window drawn from the seed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import check, trace, traffic, work
from ..reference import mdm as R

# the sub-modules whose calls the traced run spans, by their names in the MDM
MODULES = ("unet", "vae.encoder", "vae.decoder", "clip_text", "clip_image", "image_proj")
# the keys a serving mix may hold: the driver and the check read each of them
MIX_KEYS = {"driver", "about", "class_labels", "prompt_words", "steps", "cfg_scale", "cfg_img",
            "guidance_rescale", "eta", "timestep_spacing", "fps", "dtype", "quantize",
            "quantize_min_size", "check_steps", "check_frames"}


def port_config(cfg: dict):
    """The port's MDMConfig of a configuration file's dict."""
    from mudg_tpu_torch.conditioning import clip as CL
    from mudg_tpu_torch.models import mdm as M
    from mudg_tpu_torch.nn import resampler as RS
    from mudg_tpu_torch.nn import unet3d as U
    from mudg_tpu_torch.nn import vae as V

    def make(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})

    subs = {"unet": U.UNetConfig, "vae": V.VAEConfig, "resampler": RS.ResamplerConfig,
            "clip_text": CL.TextConfig, "clip_image": CL.VisionConfig}
    top = {k: v for k, v in cfg.items() if k not in subs}
    return dataclasses.replace(make(M.MDMConfig, top),
                               **{k: make(c, cfg[k]) for k, c in subs.items()})


def build_model(cfg: dict, seed: int, device, quantize: str, dtype, min_size=None):
    """The served MDM: built on the meta device, the seeded weights loaded
    strictly in fp32, then `prepare_serving_params` (quantize, cast, pack)."""
    import torch

    from mudg_tpu_torch.apps import render_infer as RI
    from mudg_tpu_torch.models import mdm as M

    from . import weights

    with torch.device("meta"):
        mdm = M.MDM(port_config(cfg))
    mdm.to_empty(device=device)
    state = weights.make(R.param_shapes(cfg), seed, device)
    with torch.no_grad():
        mdm.load_state_dict(state, strict=True)
    del state
    return RI.prepare_serving_params(mdm, quantize, dtype, min_size)


class Recorder:
    """The UNet's inputs and outputs at the checked steps of every sampler
    call, and each call's generator state at its start."""

    def __init__(self, steps):
        self.steps = set(steps)
        self.active = False
        self.calls = []      # per sampler call: {"state", "records": {step: {...}}, ...}

    def begin(self, generator):
        self.calls.append({"state": generator.get_state(), "records": {}, "step": 0,
                           "decoder": []})

    def decoder_hook(self, _module, args):
        if self.active and self.calls:
            self.calls[-1]["decoder"].append(args[0].clone())

    def hook(self, _module, args, kwargs, out):
        if not self.active or not self.calls:
            return
        call = self.calls[-1]
        step = call["step"]
        call["step"] += 1
        if step in self.steps:
            call["records"][step] = {"x": args[0].clone(), "t": args[1].clone(),
                                     "context": args[2].clone(), "v": out.clone(),
                                     "label": kwargs["c_label"].clone(),
                                     "fs": kwargs["fs"].clone()}


def run(cell: dict, seed: int, seconds: float, tracing: bool, device, t_start: float,
        quantize: str | None = None, control: str | None = None) -> dict:
    """One run of a serving cell; returns the summary the metrics read and
    the check's numbers."""
    import torch

    from mudg_tpu_torch import kernels as K
    from mudg_tpu_torch.apps import render_infer as RI

    cfg, mix = cell["config"], cell["mix"]
    if set(mix) - MIX_KEYS:
        raise ValueError(f"the serving driver does not read {sorted(set(mix) - MIX_KEYS)}")
    on_card = torch.device(device).type == "cuda"
    dtype = RI.torch_dtype(mix["dtype"])
    stages = {"imports": time.perf_counter() - t_start}
    mdm = build_model(cfg, seed, device, quantize or mix["quantize"], dtype,
                      mix.get("quantize_min_size"))
    if on_card:
        torch.cuda.synchronize()
    stages["model"] = time.perf_counter() - t_start
    sampler_kw = dict(cfg_scale=mix["cfg_scale"], cfg_img=mix.get("cfg_img"),
                      guidance_rescale=mix["guidance_rescale"], eta=mix["eta"],
                      timestep_spacing=mix["timestep_spacing"], fps=mix["fps"], dtype=dtype)
    warm_fn = RI.build_sampler(steps=1, **sampler_kw)
    timed_fn = RI.build_sampler(steps=mix["steps"], **sampler_kw)
    ids, null = traffic.tokens(cfg, mix, seed)
    tokens = torch.as_tensor(ids, device=device)
    null_tokens = torch.as_tensor(null, device=device)
    rng = np.random.default_rng(traffic.sub_seed(seed, "check"))
    check_steps = check.serve_steps(mix, rng)
    rec = Recorder(check_steps)
    hooks = [mdm.unet.register_forward_hook(rec.hook, with_kwargs=True),
             mdm.vae.decoder.register_forward_pre_hook(rec.decoder_hook)]
    state = {"warming": True, "sampler_s": 0.0}

    def sample_fn(*args, **kw):
        rec.begin(args[3])
        fn = warm_fn if state["warming"] else timed_fn
        if not tracing:
            return fn(*args, **kw)
        t0 = time.perf_counter()
        with torch.autograd.profiler.record_function(trace.PREFIX + trace.SAMPLER):
            out = fn(*args, **kw)
            if on_card:
                torch.cuda.synchronize()
        state["sampler_s"] += time.perf_counter() - t0
        return out

    generator = torch.Generator(device=device).manual_seed(traffic.sub_seed(seed, "sampler"))
    stream = traffic.windows(cfg, mix, seed, device)
    kept = []            # (window, its clip) of every window served
    loop = RI.render_windows(mdm, sample_fn, stream, tokens=tokens, null_tokens=null_tokens,
                             video_length=cfg["video_length"], generator=generator)
    win, _, out = next(loop)                       # window 0: the warm-up
    kept.append((win, out))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    state["warming"], state["sampler_s"] = False, 0.0
    rec.calls.clear()
    rec.active = True
    setup_s = time.perf_counter() - t_start
    stages["warm_up"] = setup_s
    calls_before = len(rec.calls)
    span0 = time.perf_counter()
    ends, calls_at, sampler_at = [], [], []
    while True:
        with torch.autograd.profiler.record_function(trace.PREFIX + trace.WINDOW):
            win, _, out = next(loop)
        now = time.perf_counter() - span0
        kept.append((win, out))
        ends.append(now)
        calls_at.append(len(rec.calls))
        sampler_at.append(state["sampler_s"])
        if now + now / len(ends) > seconds:
            break
    n = max(1, sum(1 for e in ends if e <= seconds))
    span_s = ends[n - 1]
    memory = torch.cuda.max_memory_allocated() if on_card else 0
    per_window = (calls_at[0] - calls_before)
    summary = {
        "kind": "serve", "windows": n, "steps": mix["steps"], "span_s": span_s,
        "setup_s": setup_s, "end_to_end": {"window_s": span_s / n, "setup_s": setup_s},
        "sampler_s": sampler_at[n - 1] if tracing else None,
        "memory_peak_bytes": memory, "attempted": n, "on_card": on_card,
        "stages": stages, "window_ends": ends,
    }
    if tracing:
        # one more window, traced, with the benchmark's spans
        spans = trace.Spans({k: mdm.get_submodule(k) for k in MODULES})
        prof = trace.profiler()
        launches0 = K.launch_counts()
        prof.start()
        with torch.autograd.profiler.record_function(trace.PREFIX + trace.WINDOW):
            next(loop)
        prof.stop()
        launches = K.launch_counts()
        spans.remove()
        f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
        summary.update(
            traced=1, forwards=mix["steps"] * per_window,
            launches={k: launches[k] - launches0[k] for k in launches0},
            trace=trace.reduce(prof, 1) if on_card else {},
            sites=work.unet_sites(cfg["unet"], 2 * len(mix["class_labels"]),
                                  cfg["video_length"], cfg["height"] // f, cfg["width"] // f),
            flops_per_window=work.serve_flops(cfg, mix, cfg["height"], cfg["width"]))
        del prof
    loop.close()
    for h in hooks:
        h.remove()
    summary["failed"] = sum(1 for _, o in kept[1:n + 1]
                            if o.shape != (len(mix["class_labels"]), cfg["video_length"],
                                           cfg["height"], cfg["width"], 3)
                            or not np.isfinite(o).all())
    # the check: one timed window drawn from the seed, the program freed first
    pick = 1 + int(rng.integers(n))
    first = calls_before + (pick - 1) * per_window
    record = {"window": kept[pick][0], "previous": kept[pick - 1][1], "clip": kept[pick][1],
              "calls": rec.calls[first:first + per_window], "tokens": ids, "null": null}
    del mdm, loop, kept, rec, warm_fn, timed_fn
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    summary["check"], summary["check_detail"] = check.serve(cfg, mix, seed, record,
                                                            check_steps, device, control)
    summary["check_s"] = time.perf_counter() - t0
    return summary
