"""Spans around the calls into each layer and their reduction from the
profiler's trace.

The spans are the benchmark's own: `torch.profiler.record_function` ranges
opened by forward hooks on the model's sub-modules and by the benchmark's
wrapper around the sampler call. Each device operation of the trace is
given to the span whose host range holds the call that launched it (the
runtime call's correlation id), the innermost first: a sub-module, else
the sampler (the step's glue), else the host (outside every sampler call).
Events stay in memory; nothing is written to disk.
"""
from __future__ import annotations

import bisect
import re

PREFIX = "portbench."
SAMPLER = "sampler"
WINDOW = "window"
HOST = "host"
NOT_KERNELS = ("Memcpy", "Memset")   # device ops that are copies and fills
PORT_KERNEL = re.compile(r"mudg::")


class Spans:
    """Forward hooks that open a profiler range named PREFIX + label around
    every call of each module of `modules` (label -> module)."""

    def __init__(self, modules: dict):
        from torch.autograd.profiler import record_function

        self.handles = []
        for label, module in modules.items():
            stack = []

            def pre(_m, _a, label=label, stack=stack):
                r = record_function(PREFIX + label)
                r.__enter__()
                stack.append(r)

            def post(_m, _a, _o, stack=stack):
                stack.pop().__exit__(None, None, None)

            self.handles += [module.register_forward_pre_hook(pre),
                             module.register_forward_hook(post)]

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def profiler():
    """A torch.profiler over the host and the card, events kept in memory."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _events(prof):
    """(ranges {label: [(start, end)]}, launchers {correlation: start},
    device ops [(name, start, end, correlation, is_kernel)]) in ns, from the
    raw results (the profiler's own event tree is not built). A device op
    (a kernel, a copy or a fill on the card) carries the correlation id of
    the host event that launched it: the operator, or the innermost range
    open around a launch made outside any operator (the port's kernels);
    `launchers` holds the start of each such host event."""
    from torch.autograd import DeviceType

    ranges, launchers, ops = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        link = e.linked_correlation_id()
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation() and name.startswith(PREFIX):
                ranges.setdefault(name[len(PREFIX):], []).append((e.start_ns(), e.end_ns()))
            if link == 0:
                launchers[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ops.append((name, e.start_ns(), e.end_ns(), link, not name.startswith(NOT_KERNELS)))
    return ranges, launchers, ops


class _Lookup:
    """The innermost labelled host range that holds an instant."""

    def __init__(self, ranges: dict):
        spans = sorted((s, e, lab) for lab, rs in ranges.items()
                       if lab not in (SAMPLER, WINDOW) for s, e in rs)
        self.mod = spans
        self.mod_starts = [s for s, _, _ in spans]
        self.samp = sorted(ranges.get(SAMPLER, []))
        self.samp_starts = [s for s, _ in self.samp]

    def label(self, t) -> str:
        i = bisect.bisect_right(self.mod_starts, t) - 1
        if i >= 0 and t <= self.mod[i][1]:
            return self.mod[i][2]
        i = bisect.bisect_right(self.samp_starts, t) - 1
        if i >= 0 and t <= self.samp[i][1]:
            return SAMPLER
        return HOST


def reduce(prof, windows: int) -> dict:
    """The trace of the first `windows` WINDOW ranges (from the first's
    start to the last's end, on the host) reduced: busy and window seconds,
    device seconds and kernel counts per span label, the port's kernels'
    device seconds, the number of each labelled range,
    the ten device operations that took most time and the ten longest idle
    stretches by what the host was doing."""
    ranges, launches, ops = _events(prof)
    spans_w = sorted(ranges.get(WINDOW, []))[:windows]
    if not spans_w:
        return {}
    start_ns, end_ns = spans_w[0][0], spans_w[-1][1]
    look = _Lookup(ranges)
    dev_s, kernels, by_name = {}, {}, {}
    port_s = total_s = 0.0
    unlinked = 0
    spans = []
    for name, s, e, corr, is_kernel in ops:
        if e < start_ns or s > end_ns:
            continue
        s, e = max(s, start_ns), min(e, end_ns)
        t0 = launches.get(corr)
        if t0 is None:
            unlinked += 1
            label = look.label(s)
        else:
            label = look.label(t0)
        d = (e - s) / 1e9
        dev_s[label] = dev_s.get(label, 0.0) + d
        total_s += d
        if is_kernel:
            kernels[label] = kernels.get(label, 0) + 1
        if PORT_KERNEL.search(name):
            port_s += d
        by_name[name] = by_name.get(name, 0.0) + d
        spans.append((s, e))
    spans.sort()
    busy, gaps, cur = 0, {}, start_ns
    for s, e in spans:
        if s > cur:
            lab = look.label(cur)
            gaps[lab] = gaps.get(lab, 0.0) + (s - cur) / 1e9
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if end_ns > cur:
        lab = look.label(cur)
        gaps[lab] = gaps.get(lab, 0.0) + (end_ns - cur) / 1e9
    count = {lab: sum(1 for s, e in rs if start_ns <= s and e <= end_ns)
             for lab, rs in ranges.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "window_s": (end_ns - start_ns) / 1e9,
            "device_s": dev_s, "kernels": kernels, "port_s": port_s, "total_s": total_s,
            "ranges": count, "unlinked": unlinked, "ops": len(spans),
            "device_ops": [[n[:120], s] for n, s in top], "idle_gaps": [[n, s] for n, s in idle]}
