"""The training driver: the MDM fine-tuning step as `train` runs it, fed by
the port's `BatchLoader` over seeded in-memory clips.

Set-up builds one training step: the MDM in fp32 from the seeded weights
(the masters), `init_train_state`, `make_train_step` with the mix's
dispatch, remat policy and accumulation; then drives that same step from
the seed through its first `check_steps` steps (the reference follows
them), on batches whose rows all differ, through the window's own call and
feed. The timed span is the longest run of whole steps back to back that
ends within the run's seconds, at least one. A traced run times its span
alike, the profiler off, and then traces one more step: the per-layer
metrics read that step's trace, and `mfu.train` and `device_idle.train`
its work over the untraced span's wall time.

The clips are `chip_smoke.py`'s `SeededClips` (copied): items with
`WaymoDataset.load_item`'s keys, shapes and dtypes, pixels uniform in
[-1, 1] from a generator seeded per item, the tasks in turn.
"""
from __future__ import annotations

import math
import time

import numpy as np

from . import check, trace, traffic, work
from ..reference import mdm as R

MODULES = ("vae.encoder", "clip_text", "clip_image", "image_proj", "unet")
TASKS = (("color", 0), ("semantic", 1), ("depth", 500))


class Clips:
    """`n` training items; item i's pixels from a generator seeded with the
    run's clip seed plus i."""

    def __init__(self, n, frames, h, w, seed):
        self.n, self.shape, self.seed = n, (frames, h, w, 3), seed

    def __len__(self):
        return self.n

    def load_item(self, index):
        rng = np.random.default_rng(self.seed + index)
        _, label = TASKS[index % len(TASKS)]
        item = {"caption": "A photo a of driving scene.", "fps": 10, "class_label": label}
        for k in ("dense_frames", "sparse_frames", "sparse_depth"):
            item[k] = rng.uniform(-1, 1, self.shape).astype(np.float32)
        return item


def run(cell: dict, seed: int, seconds: float, tracing: bool, device, t_start: float,
        quantize: str | None = None, control: str | None = None) -> dict:
    """One run of a training cell; returns the summary the metrics read and
    the check's numbers."""
    import torch

    from mudg_tpu_torch import kernels as K
    from mudg_tpu_torch.apps.train_mdm import to_device
    from mudg_tpu_torch.data.waymo import BatchLoader
    from mudg_tpu_torch.models import mdm as M
    from mudg_tpu_torch.train import step as TS

    from . import weights
    from .serve import port_config

    cfg, mix = cell["config"], cell["mix"]
    on_card = torch.device(device).type == "cuda"
    stages = {"imports": time.perf_counter() - t_start}
    with torch.device("meta"):
        mdm = M.MDM(port_config(cfg))
    mdm.to_empty(device=device)
    with torch.no_grad():
        mdm.load_state_dict(weights.make(R.param_shapes(cfg), seed, device), strict=True)
    tc = TS.TrainConfig(accum_steps=mix["accum_steps"])
    ids, null = traffic.tokens(cfg, mix, seed)
    step_fn = TS.make_train_step(mdm, tc, torch.as_tensor(null, device=device),
                                 impl=mix["impl"], remat=mix["remat"],
                                 compute_dtype={"bf16": torch.bfloat16,
                                                "f32": torch.float32}[mix["dtype"]])
    state = TS.init_train_state(mdm, tc)
    stages["model"] = time.perf_counter() - t_start
    per_step = mix["batch_size"] * mix["accum_steps"]
    warm = mix["reference_steps"]
    most = warm + math.ceil(seconds / mix["least_step_s"]) + 2
    clips = Clips(per_step * most, cfg["video_length"], cfg["height"], cfg["width"],
                  traffic.sub_seed(seed, "clips") % 2 ** 32)
    loader = BatchLoader(clips, mix["batch_size"], accum_steps=mix["accum_steps"],
                         tokenizer=lambda texts: np.stack([ids[0]] * len(texts)),
                         shuffle=True, seed=traffic.sub_seed(seed, "loader") % 2 ** 32,
                         prefetch=mix["prefetch"])
    feed = iter(loader)
    gen = torch.Generator(device=device).manual_seed(traffic.sub_seed(seed, "train"))
    wait = {"s": 0.0}

    def next_batch():
        t0 = time.perf_counter()
        with torch.autograd.profiler.record_function(trace.PREFIX + "loader"):
            b = next(feed)
        wait["s"] += time.perf_counter() - t0
        return b

    # set-up: the first steps, which the reference follows
    record = {"batches": [], "states": [], "losses": []}
    first = {}
    names = list(state.params)
    for i in range(warm):
        batch = next_batch()
        record["batches"].append(batch)
        record["states"].append(gen.get_state())
        state, metrics = step_fn(state, to_device(batch, device), gen)
        record["losses"].append(float(metrics["loss"]))
        if i == 0:
            # the first gradient as the optimizer got it: mu = (1 - beta1) g
            first = {n: float(state.mu[n].norm()) / (1.0 - tc.beta1) for n in names}
    with torch.no_grad():
        start = weights.make(R.param_shapes(cfg), seed, device)
        change = {n: float((state.params[n] - start[n].float()).norm()) for n in names}
        del start
    record.update(first_grad=first, change=change)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    stages["warm_up"] = setup_s
    wait["s"] = 0.0
    span0 = time.perf_counter()
    ends, waits = [], []
    while True:
        with torch.autograd.profiler.record_function(trace.PREFIX + trace.WINDOW):
            state, metrics = step_fn(state, to_device(next_batch(), device), gen)
            loss = float(metrics["loss"])
        now = time.perf_counter() - span0
        ends.append(now)
        waits.append(wait["s"])
        if not math.isfinite(loss) or now + now / len(ends) > seconds:
            break
    n = max(1, sum(1 for e in ends if e <= seconds))
    memory = torch.cuda.max_memory_allocated() if on_card else 0
    summary = {
        "kind": "train", "steps": n, "span_s": ends[n - 1], "setup_s": setup_s,
        "end_to_end": {"train_step_s": ends[n - 1] / n, "setup_s": setup_s},
        "data_wait_s": waits[n - 1],
        "memory_peak_bytes": memory, "attempted": n, "failed": 0 if math.isfinite(loss) else 1,
        "on_card": on_card, "stages": stages, "window_ends": ends, "windows": n,
    }
    if tracing:
        # one more step, traced, with the benchmark's spans
        spans = trace.Spans({k: mdm.get_submodule(k) for k in MODULES})
        prof = trace.profiler()
        launches0 = K.launch_counts()
        prof.start()
        with torch.autograd.profiler.record_function(trace.PREFIX + trace.WINDOW):
            state, metrics = step_fn(state, to_device(next_batch(), device), gen)
            float(metrics["loss"])
        prof.stop()
        launches = K.launch_counts()
        spans.remove()
        f = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
        summary.update(
            traced=1, launches={k: launches[k] - launches0[k] for k in launches0},
            trace=trace.reduce(prof, 1) if on_card else {},
            train_sites=work.train_sites(cfg["unet"], mix["batch_size"], cfg["video_length"],
                                         cfg["height"] // f, cfg["width"] // f),
            flops_per_step=work.train_flops(cfg, mix))
        del prof
    del mdm, state, step_fn, feed, loader
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    summary["check"], summary["check_detail"] = check.train(cfg, mix, seed, record, ids, null,
                                                            device, control)
    summary["check_s"] = time.perf_counter() - t0
    return summary
