"""Readings for the check's limits: the numbers one cell's check compares,
over many seeds in one process (the kernels built once), for the program
as the cell runs it or for its control.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--quantize int8] [--seconds 1]

Each seed is a whole run of the cell: set-up from that seed, the warm-up,
the timed windows within --seconds (one, at the default), the check. One
JSON line per seed on standard output, with `correct` as the cell's limits
judge it. `--quantize int8` serves the UNet in W8A8 int8, the program's own
path below the configuration's bf16; `--control fp8` puts the reference in
fp8 in the program's place: controls, which the check has to refuse. The
benchmark's runs never run this script.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402
from portbench.harness import spec  # noqa: E402


def main(argv=None, root=run.ROOT, device="cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--quantize", default=None)
    p.add_argument("--control", default=None, choices=(None, "fp8"))
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", default=None,
                   help="a fault of harness/faults.py planted in the program")
    args = p.parse_args(argv)
    cell = spec.cell(root, args.workload)
    if args.fault:
        from portbench.harness import faults

        kind = faults.SERVE if cell["mix"]["driver"] == "serve" else faults.TRAIN
        kind[args.fault]()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        s = run.run_cell(cell, seed, args.seconds, False, device, args.quantize, args.control)
        correct = run.result(root, cell, s, False)[2]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "quantize": args.quantize,
                          "fault": args.fault,
                          "control": args.control, "setup_s": s["setup_s"],
                          "check_s": s["check_s"],
                          "check": s["check"], "failed": s["failed"], "windows": s["windows"],
                          "e2e": s["end_to_end"], "detail": s["check_detail"],
                          "run_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
