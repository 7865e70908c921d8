"""A temporary checkout root holding a copy of the benchmark's folder and a
BENCHMARK.json of two tiny cells, for runs on the CPU: "tiny.serve" (the
port's tiny preset at 32x64 over 4 frames under serve3_s50, 3 steps) and
"tiny.train" (the same configuration under train_b2), both in fp32 so that
the check's limits sit far below any fault."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
TINY_MIX = {"steps": 3, "dtype": "f32", "prompt_words": 3}
TINY_LIMITS = {"start_gap": 0.0, "cond_gap": 1e-4, "unet_gap": 1e-4, "step_gap": 1e-3,
               "decode_gap": 1e-4}
TINY_TRAIN_MIX = {"dtype": "f32", "least_step_s": 0.5}
TINY_TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3}


def _write(path: Path, base: Path, changes: dict):
    m = json.loads(base.read_text())
    m.update(changes)
    path.write_text(json.dumps(m))


def tiny_root(tmp: Path, mix: dict | None = None, limits: dict | None = None,
              train_mix: dict | None = None) -> Path:
    """The root; `mix`, `limits` and `train_mix` change TINY_MIX,
    TINY_LIMITS and TINY_TRAIN_MIX."""
    root = Path(tmp)
    bench = root / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH / "tests" / "tiny.json", bench / "configs" / "tiny.json")
    _write(bench / "mixes" / "tiny_serve.json", BENCH / "mixes" / "serve3_s50.json",
           {**TINY_MIX, **(mix or {})})
    _write(bench / "mixes" / "tiny_train.json", BENCH / "mixes" / "train_b2.json",
           {**TINY_TRAIN_MIX, **(train_mix or {})})
    for cell, lim in (("tiny.serve", {**TINY_LIMITS, **(limits or {})}),
                      ("tiny.train", TINY_TRAIN_LIMITS)):
        (bench / "limits" / f"{cell}.json").write_text(
            json.dumps({k: {"limit": v} for k, v in lim.items()}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "the port's tiny preset",
                            "file": "portbench/configs/tiny.json", "reduced": [],
                            "why": "CPU tests"})
    spec["workloads"] = [
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny_serve", "chips": 1,
         "why": "CPU tests"},
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train", "chips": 1,
         "why": "CPU tests"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.serve"]
    # the training cell's metrics, which BENCHMARK.json names with its cell
    spec["end_to_end"].append({"name": "train_step_s", "unit": "s", "better": "lower",
                               "bound": 0.25, "source": "host_clock", "workloads": ["tiny.train"]})
    spec["per_layer"] += [{"name": p.stem, "unit": "x", "better": "lower",
                           "source": "device_trace", "layer": "training",
                           "moves": "train_step_s", "workloads": ["tiny.train"]}
                          for p in sorted((bench / "metrics").glob("*.train.py"))]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
