"""Whole runs of a tiny serving cell on the CPU: the result line, the
check passing the program and refusing its control and each planted fault,
and a configuration, mix and per-layer metric taken as new files alone."""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.harness import faults
from portbench.tests.helpers import BENCH, TINY_MIX, TINY_TRAIN_MIX, tiny_root

SEED = ["--seed", "3000000017", "--seconds", "0.1"]


def run_tiny(root, trace=0, cell="tiny.serve", **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, *SEED, "--trace", str(trace)], root=root,
                      device="cpu", **kw)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


CHECKED = {"serve": {"start_gap", "cond_gap", "unet_gap", "step_gap", "decode_gap"},
           "train": {"loss_gap", "grad_gap", "change_gap"}}
E2E = {"serve": "window_s", "train": "train_step_s"}


@pytest.mark.parametrize("mix", sorted(p.stem for p in (BENCH / "mixes").glob("*.json")))
@pytest.mark.parametrize("trace", [0, 1])
def test_mix_end_to_end(tmp_path, mix, trace):
    """Each mix at the tiny preset on the CPU: the result line's keys, and
    the check passing the program."""
    base = json.loads((BENCH / "mixes" / f"{mix}.json").read_text())
    kind = base["driver"]
    if kind == "serve":
        root = tiny_root(tmp_path, mix={k: v for k, v in base.items() if k not in TINY_MIX})
    else:
        root = tiny_root(tmp_path, train_mix={k: v for k, v in base.items()
                                              if k not in TINY_TRAIN_MIX})
    line = run_tiny(root, trace, cell=f"tiny.{kind}")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["check"]) == CHECKED[kind]
    if trace:
        assert E2E[kind] not in line["metrics"] and line["metrics"]
    else:
        assert set(line["metrics"]) == {E2E[kind], "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_planted_fault_fails(tmp_path, fault):
    root = tiny_root(tmp_path)
    undo = faults.SERVE[fault]()
    try:
        assert run_tiny(root)["correct"] is False
    finally:
        undo()


def test_control_fails(tmp_path):
    """The program's int8 path (W8A8 UNet) below the configuration's
    precision: the check refuses it."""
    root = tiny_root(tmp_path, mix={"quantize_min_size": 0})
    assert run_tiny(root)["correct"] is True
    assert run_tiny(root, quantize="int8")["correct"] is False


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_planted_train_fault_fails(tmp_path, fault):
    root = tiny_root(tmp_path)
    undo = faults.TRAIN[fault]()
    try:
        assert run_tiny(root, cell="tiny.train")["correct"] is False
    finally:
        undo()


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_fp8_control_fails(tmp_path, kind):
    """The reference in fp8 in the program's place, judged by the run's own
    result: not correct, each number it takes over past its limit."""
    from portbench.tests.helpers import TINY_LIMITS, TINY_TRAIN_LIMITS

    root = tiny_root(tmp_path)
    line = run_tiny(root, cell=f"tiny.{kind}", control="fp8")
    assert line["correct"] is False
    moved = ({"cond_gap", "step_gap", "decode_gap"} if kind == "serve"
             else set(TINY_TRAIN_LIMITS))
    limits = TINY_LIMITS if kind == "serve" else TINY_TRAIN_LIMITS
    assert any(line["check"][k]["value"] > limits[k] for k in moved)
    assert set(line["check"]) == CHECKED[kind]


def test_train_reference_uses_bf16_weights(tmp_path):
    """In bf16 the reference uses each weight rounded to bf16, as the
    program's forward does: Adam's first update (about 1e-5 an element)
    rounds away on most weights in both, and the later steps' losses agree
    (a reference on the unrounded masters parts from the program by about
    0.6% here, and by 2-4x at MDM512)."""
    from portbench.harness import spec

    root = tiny_root(tmp_path, train_mix={"dtype": "bf16"})
    s = run.run_cell(spec.cell(root, "tiny.train"), 7, 0.1, False, "cpu")
    assert s["check_detail"]["train"]["later_losses_gap"] < 2e-3


def test_mix_key_not_read_is_refused(tmp_path):
    """A serving mix that names a key the driver does not read (task-serial
    requests, 3-point CFG) is refused, not run as something else."""
    root = tiny_root(tmp_path, mix={"task_serial": True})
    with pytest.raises(ValueError, match="task_serial"):
        run_tiny(root)


def _digests(folder: Path) -> dict:
    return {p.relative_to(folder).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_metric_are_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    bench = root / "portbench"
    (bench / "metrics" / "windows_seen.serve.py").write_text(
        "def read(s):\n    return float(s['windows'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "windows_seen.serve", "unit": "windows", "better": "higher",
                              "source": "program_counter", "layer": "serving app",
                              "moves": "window_s", "workloads": ["tiny.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    before = _digests(BENCH)
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert {"configs/tiny.json", "mixes/tiny_serve.json", "limits/tiny.serve.json",
            "metrics/windows_seen.serve.py"} <= set(after) - set(before)
    line = run_tiny(root, trace=1)
    assert line["metrics"]["windows_seen.serve"] == {"value": 1.0, "unit": "windows"}


def test_no_card_no_result(capsys):
    """Without a CUDA device the run prints no result and exits non-zero."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "mdm512.serve3_s50", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_named_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mudg_tpu_torch_like", object())
    assert "mudg_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.loaded_forbidden() == ["jaxlib"]
