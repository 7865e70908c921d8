"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), device, and
with --trace 1 a breakdown of the trace; each number the check compared
goes beside its limit under "check", last in the line and in the last
lines of standard error. Exits non-zero, printing no result, where the card
or the cell's number of cards is missing, or where JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mudg_tpu")


def loaded_forbidden() -> list[str]:
    """Modules loaded whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_report(summary, device, tracing):
    import torch

    if torch.device(device).type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(summary["memory_peak_bytes"])}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    tr = summary.get("trace") or {}
    if tracing and tr:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
    return dev


def run_cell(cell, seed, seconds, tracing, device, quantize=None, control=None):
    """The driver the cell's mix names, run once: its summary."""
    from portbench.harness import serve, train

    drivers = {"serve": serve.run, "train": train.run}
    return drivers[cell["mix"]["driver"]](cell, seed, seconds, tracing, device, T_START,
                                          quantize, control)


def result(root, cell, summary, tracing):
    """The result line's metrics, the check's numbers beside their limits,
    and whether the run is correct."""
    from portbench.harness import spec

    if tracing:
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.reader(root, m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": summary["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"] if m["name"] in summary["end_to_end"]}
    check = {k: {"value": v, "limit": cell["limits"][k]["limit"]}
             for k, v in summary["check"].items()}
    correct = (summary["failed"] == 0 and bool(check)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in check.values()))
    return metrics, check, correct


def main(argv=None, root=ROOT, device=None, quantize=None, control=None) -> int:
    """quantize and control put a control in the program's place (the
    program's int8 path; the reference in fp8): the calibration and the
    tests pass them, the benchmark's runs never."""
    args = parse(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness import spec

    cell = spec.cell(root, args.workload)
    import torch

    if device is None:
        need = cell["entry"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"portbench: {need} CUDA device(s) needed, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2
        device = "cuda"
    tracing = bool(args.trace)
    summary = run_cell(cell, args.seed, args.seconds, tracing, device, quantize, control)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 3
    metrics, check, correct = result(root, cell, summary, tracing)
    line = {"correct": correct, "attempted": summary["attempted"], "failed": summary["failed"],
            "metrics": metrics, "device": device_report(summary, device, tracing)}
    tr = summary.get("trace") or {}
    if tracing and tr:
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["check"] = check
    print(f"portbench: set-up stages (s from start) {summary['stages']}, window ends "
          f"{summary['window_ends']}, windows {summary['windows']}, check "
          f"{summary['check_s']:.3f} s", file=sys.stderr)
    if tr:
        print(f"portbench: trace {tr['ops']} device ops, {tr['unlinked']} without their launch, "
              f"device s {tr['device_s']}, kernels {tr['kernels']}, ranges {tr['ranges']}",
              file=sys.stderr)
    for k, c in check.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
