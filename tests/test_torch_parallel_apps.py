"""The apps over 2 ranks on the CPU (gloo), as torchrun would run them: one
spawn (tests/torch_parallel_ranks.py) runs `python -m mudg_tpu_torch`'s
main on both ranks for each of
  * `train` data parallel (batch 2, accumulation 2, EMA, 2 steps), with
    ZeRO-2 moments and with `--fsdp`, whose trainstate_2 resumes in one
    process to the same state, bit for bit;
  * `train --tp 2` and `train --sp 2` (a step each, the files written);
  * `render --seq_parallel`, whose files are those of a one-process run
    (images within one level of 255, depth within 1e-3: the one-process
    run takes the kernels' path, the sharded one the plain path, as JAX
    takes "xla" under SP), written by rank 0 alone;
  * `serve --seq_parallel` answering one spool request once, rank 0 alone
    writing.
And `--tp` with `--sp` is refused (exit 2) before any process group forms.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from mudg_tpu_torch.apps import render_infer as TR
from mudg_tpu_torch.apps import train_mdm as TA
from mudg_tpu_torch.conditioning.tokenizer import HashTokenizer
from mudg_tpu_torch.train import checkpoint as TC
from test_torch_apps import scene_items

H, W, VL = 32, 64, 4
SIZE = ["--preset", "tiny", "--height", str(H), "--width", str(W), "--video_length", str(VL),
        "--device", "cpu"]
RENDER = ["--steps", "1", "--max_windows", "1", "--dtype", "f32"]


def _train(items, out, *extra):
    return ["train", "--items", items, "--out", str(out), *SIZE, "--log_every", "1",
            "--use_ema", *extra]


@pytest.fixture(scope="module")
def apps(scene, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_apps")
    items = scene_items(scene, tmp / "items.txt", 4)
    spool = tmp / "spool"
    spool.mkdir()
    (spool / "r0.json").write_text(json.dumps({"items": items, "out": str(tmp / "served"),
                                               "max_windows": 1}))
    one_step = ["--batch_size", "1", "--accum", "2", "--max_steps", "1", "--ckpt_every", "1",
                "--full_ckpt_every", "1"]
    two_steps = ["--batch_size", "2", "--accum", "2", "--max_steps", "2", "--ckpt_every", "2",
                 "--full_ckpt_every", "2"]
    runs = {
        "dp": _train(items, tmp / "dp", *two_steps),
        "fsdp": _train(items, tmp / "fsdp", *two_steps, "--fsdp"),
        "tp": _train(items, tmp / "tp", *one_step, "--tp", "2"),
        "sp": _train(items, tmp / "sp", *one_step, "--sp", "2"),
        "render": ["render", "--items", items, "--out", str(tmp / "render2"), *SIZE, *RENDER,
                   "--seq_parallel"],
        "serve": ["serve", "--spool", str(spool), *SIZE, "--steps", "1", "--dtype", "f32",
                  "--max_requests", "1", "--seq_parallel"],
    }
    got = R.spawn(R.run_apps, 2, tmp, list(runs.values()))
    return {"tmp": tmp, "items": items,
            "ranks": [dict(zip(runs, r)) for r in got]}


def _records(out):
    return [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]


@pytest.mark.parametrize("run", ["dp", "fsdp", "tp", "sp", "render", "serve"])
def test_apps_run_at_2_ranks_and_only_rank_0_writes(apps, run):
    r0, r1 = (r[run] for r in apps["ranks"])
    assert r0["rc"] in (0, None) and r1["rc"] in (0, None), (r0, r1)
    assert r0["writes"] > 0 and r1["writes"] == 0, (r0, r1)


@pytest.mark.parametrize("run,files", [
    ("dp", ["final", "metrics.jsonl", "step_2", "trainstate_2"]),
    ("fsdp", ["final", "metrics.jsonl", "step_2", "trainstate_2"]),
    ("tp", ["final", "metrics.jsonl", "step_1", "trainstate_1"]),
    ("sp", ["final", "metrics.jsonl", "step_1", "trainstate_1"])])
def test_train_at_2_ranks_writes_its_files(apps, run, files):
    """The records are finite, and the merged state dict `final` loads
    strictly into a one-process MDM (the shards gathered whole)."""
    out = apps["tmp"] / run
    assert sorted(os.listdir(out)) == files
    recs = [r for r in _records(out) if "loss" in r]
    assert recs and all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in recs)
    args = TA.parser().parse_args(["--items", "x", "--out", "y", *SIZE])
    cfg, _, _ = TA.recipe(args)
    from mudg_tpu_torch.models import mdm as M

    M.MDM(cfg).load_state_dict(TC.load(str(out / "final")), strict=True)


@pytest.mark.parametrize("run", ["dp", "fsdp"])
def test_trainstate_of_2_ranks_resumes_in_one_process(apps, tmp_path, run):
    """trainstate_2 written by 2 ranks (ZeRO-2 moments, or FSDP's shards,
    gathered to rank 0) restores into a one-process run: params, mu, nu,
    count, EMA and step bit for bit."""
    src = apps["tmp"] / run
    out = tmp_path / "resume"
    out.mkdir()
    (out / "trainstate_2").write_bytes((src / "trainstate_2").read_bytes())
    saved = TC.load(str(out / "trainstate_2"))
    args = TA.parser().parse_args(_train(apps["items"], out, "--batch_size", "2", "--accum",
                                         "2", "--max_steps", "3", "--auto_resume",
                                         "--full_ckpt_every", "0", "--ckpt_every", "9")[1:])
    tok = HashTokenizer()
    loader, _ = TA.loaders(args, (H, W), tok)
    seen = {}

    def on_step(step_i, state, metrics):
        if metrics is None:
            seen["step"], seen["count"] = step_i, state.count
            seen["state"] = {k: {n: t.detach().clone() for n, t in getattr(state, k).items()}
                             for k in ("params", "mu", "nu", "ema")}

    TA.train(args, loader, tokenizer=tok, on_step=on_step)
    assert seen["step"] == 2 and seen["count"] == saved["count"] == 2
    for k, tree in seen["state"].items():
        assert set(tree) == set(saved[k])
        for n, t in tree.items():
            assert torch.equal(t, saved[k][n]), (k, n)


def test_render_seq_parallel_writes_what_one_process_writes(apps, tmp_path):
    out1 = tmp_path / "render1"
    assert TR.main(["--items", apps["items"], "--out", str(out1), *SIZE, *RENDER]) == 0
    out2 = apps["tmp"] / "render2"

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(out1) == files(out2) and files(out1)
    import cv2

    for name in files(out1):
        a, b = str(out1 / name), str(out2 / name)
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(a), np.load(b), atol=1e-3, rtol=0)
        elif name.endswith(".png"):
            diff = np.abs(cv2.imread(a).astype(int) - cv2.imread(b).astype(int))
            assert diff.max() <= 1, name


def test_serve_seq_parallel_answers_once(apps):
    spool = apps["tmp"] / "spool"
    assert sorted(os.listdir(spool)) == ["r0.done"]
    done = json.loads((spool / "r0.done").read_text())
    assert done["windows"] == 1 and done["request"] == "r0.json"
    for task in ("color", "depth", "semantic"):
        assert os.path.exists(apps["tmp"] / "served" / f"virtual_{task}" / f"{task}_re_0.png")


def test_tp_with_sp_is_refused(tmp_path):
    with pytest.raises(SystemExit) as e:
        TA.main(_train("unused.txt", tmp_path / "run", "--tp", "2", "--sp", "2")[1:])
    assert e.value.code == 2 and not os.path.exists(tmp_path / "run")
