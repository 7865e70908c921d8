"""Profiling helpers (the reference's CUDACallback, `main/callbacks.py:104-133`).

Port of `mudg_tpu/utils/profiling.py`:
  * `device_memory_stats`: per-GPU memory in use, its peak and the card's
    total, from `torch.cuda.memory_stats` (an empty list without CUDA),
  * `StepTimer`: rolling step-time statistics (a copy),
  * `trace`: a `torch.profiler` scope that writes a Chrome trace,
  * `stage_clock`: a stage's seconds added to a dict of timings.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np


def device_memory_stats() -> list[dict]:
    """Per-GPU memory stats (bytes) of the caching allocator."""
    import torch

    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out


class StepTimer:
    """Rolling wall-clock statistics over train/inference steps."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: list[float] = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    def stats(self) -> dict:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "mean_s": float(t.mean()),
            "p50_s": float(np.median(t)),
            "p90_s": float(np.percentile(t, 90)),
            "steps_per_sec": float(1.0 / max(t.mean(), 1e-9)),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where available); the
    Chrome trace is written to <log_dir>/trace.json. Yields the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def stage_clock(timings: dict | None, stage: str, device=None):
    """Add the seconds the block takes to timings[stage] (host clock; a
    CUDA `device` synchronized at the block's end); nothing when timings
    is None."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            import torch

            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            timings[stage] = timings.get(stage, 0.0) + time.perf_counter() - t0
