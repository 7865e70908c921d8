"""Profiling helpers (the reference's CUDACallback, `main/callbacks.py:104-133`).

Port of `mudg_tpu/utils/profiling.py`:
  * `device_memory_stats`: per-GPU memory in use, its peak and the card's
    total, from `torch.cuda.memory_stats` (an empty list without CUDA),
  * `trace`: a `torch.profiler` scope, with the program's spans on, that
    writes a Chrome trace,
  * `stage_clock`: a stage's seconds added to a dict of timings,
and the program's spans:
  * `span(name)`: a context manager around a piece of the program's work.
    Off (the default) it returns one shared null context: no clock read, no
    allocation. On (`enable_spans(True)`) it adds its count and host-clock
    nanoseconds to a total kept per nesting path ("unet/unet.res" is a
    `unet.res` span inside a `unet` span), and, while a torch profiler is
    recording, opens the range `PREFIX + name`, which lands in the profiler's
    trace beside the device operations launched inside it. Spans nest on
    the thread that opens them; the program opens them on its main thread.
  * `span_totals()`, `reset_spans()`: the totals, and clearing them.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

PREFIX = "mudg."      # the profiler range of span(name) is PREFIX + name

_on = False
_NULL = contextlib.nullcontext()
_stack: list[str] = []                 # the nesting paths of the open spans
_totals: dict[str, list[int]] = {}     # nesting path -> [count, host ns]


class _Span:
    __slots__ = ("name", "path", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.path = f"{_stack[-1]}/{self.name}" if _stack else self.name
        _stack.append(self.path)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack.pop()
        total = _totals.setdefault(self.path, [0, 0])
        total[0] += 1
        total[1] += ns
        return False


def span(name: str):
    """A span of the program's work named `name` (see the module's note)."""
    if not _on:
        return _NULL
    return _Span(name)


def enable_spans(flag: bool) -> None:
    global _on
    _on = bool(flag)


def span_totals() -> dict[str, dict]:
    """nesting path -> {"count": spans closed, "ns": their host-clock ns}."""
    return {path: {"count": n, "ns": ns} for path, (n, ns) in _totals.items()}


def reset_spans() -> None:
    _totals.clear()


def device_memory_stats() -> list[dict]:
    """Per-GPU memory stats (bytes) of the caching allocator."""
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


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where available), the
    program's spans on inside it; the Chrome trace is written to
    <log_dir>/trace.json, also where the block raises. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    prof = torch.profiler.profile(activities=acts)
    enable_spans(True)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        enable_spans(was_on)
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
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            timings[stage] = timings.get(stage, 0.0) + time.perf_counter() - t0
