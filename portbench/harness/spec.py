"""The benchmark as data: `BENCHMARK.json` at the checkout's root names the
cells; each cell's configuration, traffic mix and limits, and each
per-layer metric's reader, are files of their own under the benchmark's
folder, found by name:

  configs/<config>.json      the configuration's sizes (BENCHMARK.json's `file`)
  mixes/<traffic>.json       the traffic's parameters, read by the driver it names
  limits/<workload>.json     each compared number's limit, and the readings
  metrics/<metric>.py        a per-layer metric's reader, `read(summary)`

Adding a cell, configuration, mix or metric adds files and entries and
edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path



def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def bench_dir(root: Path) -> Path:
    """The benchmark's folder: the first of BENCHMARK.json's `paths`."""
    return Path(root) / load(root)["paths"][0]


def cell(root: Path, workload: str) -> dict:
    """Everything one cell's run reads: its BENCHMARK.json entry, the
    configuration, the mix, the limits, and the end-to-end and per-layer
    metrics that it reports."""
    bench = load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((Path(root) / conf["file"]).read_text())
    here = bench_dir(root)
    mix = json.loads((here / "mixes" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{workload}.json").read_text())

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (applies(m) if "workloads" in m else m["moves"] in reported)]
    return {"entry": entry, "config": config, "mix": mix, "limits": limits,
            "end_to_end": e2e, "per_layer": per_layer}


def reader(root: Path, name: str):
    """The `read` function of the per-layer metric `name`."""
    path = bench_dir(root) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
