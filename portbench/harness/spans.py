"""The program's own spans read from the profiler's trace.

The port opens a profiler range named `PREFIX + name` around each span of
its work (`mudg_tpu_torch.utils.profiling.span`) while its spans are on and
a profiler records: the render window's host stages, the towers, each VAE
frame, each sampler step, the UNet and its blocks, and each kernel
wrapper's call into the kernel library. Each device operation goes to
the spans open when the host called the CUDA runtime or driver to launch
it: the trace gives that call the device operation's own correlation id.
The port's kernels are launched through ctypes outside any ATen operator:
on the H100 their device operations carry no link to a host operator or
range (the link `harness/trace.py` follows), but their launch calls lie
inside their `kernel.*` spans.

`events` takes the raw results apart into plain lists; `reduce` works on
those lists alone, so the tests feed it synthetic events. Within a window
it gives: per kernel span name, the `mudg::` device time and the calls;
the UNet's calls, device time and glue (device time of the operations that
are not the port's kernels), the glue by the innermost span that launched
it; and the device's idle gaps by the innermost span open at each gap's
start. The names are the program's; nothing of the program is imported.
"""
from __future__ import annotations

import bisect

from . import trace, work

PREFIX = "mudg."          # the program's range prefix (`profiling.PREFIX`)
KERNEL = "kernel."        # the kernel wrappers' spans: KERNEL + the kernel's name
UNET = "unet"
OUTSIDE = "host"          # no program span open


def events(prof):
    """(ranges [(name, start, end)] of the program's spans, windows
    [(start, end)] of the benchmark's window ranges, launchers {correlation:
    start of the runtime or driver call}, device ops [(name, start, end,
    correlation)]) in ns, from the profiler's raw results."""
    from torch.autograd import DeviceType

    ranges, windows, launchers, ops = [], [], {}, []
    window = trace.PREFIX + trace.WINDOW
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation():
                if name.startswith(PREFIX):
                    ranges.append((name[len(PREFIX):], e.start_ns(), e.end_ns()))
                elif name == window:
                    windows.append((e.start_ns(), e.end_ns()))
            elif name.startswith("cu") and "::" not in name:
                # a CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernelEx,
                # cudaMemcpyAsync, ...), not an operator
                launchers[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ops.append((name, e.start_ns(), e.end_ns(), e.correlation_id()))
    return ranges, sorted(windows), launchers, ops


class Nest:
    """The program's spans as the tree their nesting makes (spans of one
    thread nest or are disjoint): the innermost span open at an instant and
    the names from it out to the outermost."""

    def __init__(self, ranges):
        self.spans = sorted(ranges, key=lambda r: (r[1], -r[2]))
        self.starts = [s for _, s, _ in self.spans]
        self.parent, open_ = [], []
        for i, (_, s, e) in enumerate(self.spans):
            while open_ and self.spans[open_[-1]][2] <= s:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def innermost(self, t) -> int:
        """The index of the innermost span open at t, -1 where none is."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][2] < t:
            i = self.parent[i]
        return i

    def names(self, i) -> list[str]:
        out = []
        while i >= 0:
            out.append(self.spans[i][0])
            i = self.parent[i]
        return out


def _add(d, k, v):
    d[k] = d.get(k, 0.0) + v


def reduce(ranges, launchers, ops, start_ns, end_ns) -> dict:
    """The window [start_ns, end_ns] of the trace (device ops clipped to
    it) by the program's spans; see the module's note. Each device op goes
    to the spans open at its launch (the start of the runtime or driver
    call its correlation id names; its own start where the trace lost the
    call)."""
    nest = Nest(ranges)
    kernels, glue = {}, {}
    port_s = spanned_port_s = unet_s = 0.0
    busy = []
    for name, s, e, corr in ops:
        if e < start_ns or s > end_ns:
            continue
        s, e = max(s, start_ns), min(e, end_ns)
        d = (e - s) / 1e9
        busy.append((s, e))
        names = nest.names(nest.innermost(launchers.get(corr, s)))
        port = trace.PORT_KERNEL.search(name) is not None
        if port:
            port_s += d
            kernel = next((n for n in names if n.startswith(KERNEL)), None)
            if kernel is not None:
                spanned_port_s += d
                k = kernels.setdefault(kernel[len(KERNEL):], {"s": 0.0, "calls": 0})
                k["s"] += d
        if UNET in names:
            unet_s += d
            if not port:
                _add(glue, names[0], d)
    for name, s, e in ranges:
        if name.startswith(KERNEL) and start_ns <= s and e <= end_ns:
            k = kernels.setdefault(name[len(KERNEL):], {"s": 0.0, "calls": 0})
            k["calls"] += 1
    gaps, cur = {}, start_ns
    for s, e in sorted(busy):
        if s > cur:
            i = nest.innermost(cur)
            _add(gaps, nest.spans[i][0] if i >= 0 else OUTSIDE, (s - cur) / 1e9)
        cur = max(cur, e)
    if end_ns > cur:
        i = nest.innermost(cur)
        _add(gaps, nest.spans[i][0] if i >= 0 else OUTSIDE, (end_ns - cur) / 1e9)
    unet_calls = sum(1 for n, s, e in ranges if n == UNET and start_ns <= s and e <= end_ns)
    return {"kernels": kernels, "port_s": port_s, "spanned_port_s": spanned_port_s,
            "unet": {"calls": unet_calls, "device_s": unet_s, "glue_s": sum(glue.values())},
            "glue_by_span": dict(sorted(glue.items(), key=lambda kv: -kv[1])),
            "idle_gaps": dict(sorted(gaps.items(), key=lambda kv: -kv[1]))}


def reduce_profile(prof, windows: int) -> dict:
    """`reduce` over the first `windows` window ranges of the trace (from
    the first's start to the last's end); {} where it holds none."""
    ranges, spans_w, launchers, ops = events(prof)
    spans_w = spans_w[:windows]
    if not spans_w:
        return {}
    return reduce(ranges, launchers, ops, spans_w[0][0], spans_w[-1][1])


def kernel_roofline(s: dict, kernel: str) -> float | None:
    """The share (%) of its roofline that `kernel` reached in a served
    window's trace: the least time of its calls' work (each at the mean
    work of its sites in one UNet forward) over the `mudg::` device time
    inside its spans; None where the summary holds neither."""
    k = ((s.get("program_trace") or {}).get("kernels") or {}).get(kernel)
    if s.get("kind") != "serve" or not k or not k["s"] or not s.get("sites"):
        return None
    least = work.kernel_least_s({kernel: k["calls"]}, s["sites"])
    return None if not least else 100.0 * least / k["s"]
