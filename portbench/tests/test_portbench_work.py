"""The yardstick's arithmetic against hand counts: each kernel's work at
one site, the least time, the roofline of a set of launches, the kernel
sites of a UNet forward against chip_smoke.py's table, and the model FLOPs
that the plain reference counts on the meta device."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import work
from portbench.reference import mdm as R

BENCH = Path(__file__).resolve().parent.parent


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_work_by_hand():
    # kernel 1 at 2 frames of L = 64 tokens, C = 64: q, k, v and out
    # projections 4 x 2 L C^2, the products Q K^T and P V 2 x 2 L^2 C
    f, b = work.work_spatial(2, 64, 64)
    assert f == 2 * (4 * 2 * 64 * 64 * 64 + 2 * 2 * 64 * 64 * 64)
    assert b == 2 * 2 * 2 * 64 * 64 + 2 * 4 * 64 * 64 + 4 * 3 * 64
    # kernel 2: two stages over 128 positions of 16 frames
    f, _ = work.work_temporal(128, 16, 64)
    assert f == 2 * (4 * 2 * 2048 * 64 * 64 + 2 * 2 * 2048 * 16 * 64)
    # kernel 3: GEGLU, C -> 8C -> C over 256 rows
    f, _ = work.work_ff(256, 64, True)
    assert f == 2 * 256 * 64 * 512 + 2 * 256 * 256 * 64
    # kernel 4: three taps of a C x C product per position
    f, _ = work.work_tconv(1, 4, 2, 2, 32)
    assert f == 3 * 2 * 16 * 32 * 32
    # kernel 5: S = Q K^T and O = P V per (sequence, head)
    f, b = work.work_flash(3, 128, 2, 64)
    assert f == 2 * 2 * 3 * 2 * 128 * 128 * 64
    assert b == 4 * 2 * 3 * 128 * 2 * 64 + 4 * 3 * 2 * 128


def test_least_time_and_roofline():
    assert work.least_s(989e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)
    sites = {"a": [(989e9, 0), (3 * 989e9, 0)], "b": [(0, 3.35e9)]}
    # 4 launches of a at the mean of its sites (2 ms) and one of b (1 ms)
    assert work.kernel_least_s({"a": 4, "b": 1, "c": 0}, sites) == pytest.approx(9e-3)
    assert work.kernel_least_s({"c": 1}, sites) is None


@pytest.mark.parametrize("name,flash", [("mdm512", 0), ("mdm1024", 5)])
def test_sites_equal_chip_smoke_table(name, flash):
    """chip_smoke.py's SITES: each kernel's sites in one bf16 UNet forward."""
    cfg = config(name)
    f = 8
    sites = work.unet_sites(cfg["unet"], 6, 16, cfg["height"] // f, cfg["width"] // f)
    assert {k: len(v) for k, v in sites.items()} == {
        "spatial_attn": 10, "temporal_attn": 11, "geglu_ff": 33, "gn_silu_tconv": 20,
        "flash_attention": flash}


def test_flop_counter_by_hand():
    """A text tower of one layer of width 64 over 77 tokens and 2 rows."""
    w, l, b = 64, 77, 2
    t = {"vocab_size": 100, "width": w, "heads": 2, "layers": 2, "context_length": l,
         "skip_last_layers": 1}
    P = {k: torch.empty(s, device="meta") for k, s in
         R.param_shapes({**config("mdm512"), "clip_text": t}).items()
         if k.startswith("clip_text.")}
    counter = FlopCounterMode(display=False)
    with counter:
        R.text_encode(P, t, torch.zeros(b, l, dtype=torch.long, device="meta"))
    rows = b * l
    hand = (2 * rows * w * 3 * w + 2 * 2 * b * l * l * w + 2 * rows * w * w
            + 2 * 2 * rows * w * 4 * w)
    assert counter.get_total_flops() == hand


def test_serve_flops_counts_every_forward():
    cfg, mix = config("mdm512"), json.loads((BENCH / "mixes" / "serve3_s50.json").read_text())
    one = work.serve_flops(cfg, {**mix, "steps": 1}, 320, 512)
    none = work.serve_flops(cfg, {**mix, "steps": 0}, 320, 512)
    full = work.serve_flops(cfg, mix, 320, 512)
    assert full == pytest.approx(none + 50 * (one - none))
    # one batch-6 forward: 75.6 TFLOP, by far the most of a window
    assert 7.0e13 < one - none < 8.0e13


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_whole_window_metrics_read_the_untraced_span(kind):
    """mfu and device_idle divide by the untraced span's wall time a window
    (or step), never by the traced window, which the profiler stretches."""
    from portbench.harness import spec

    root = BENCH.parent
    s = {"kind": kind, "span_s": 10.0, "windows": 2, "steps": 2, "traced": 1,
         "flops_per_window": 0.5e15, "flops_per_step": 0.5e15,
         "trace": {"ops": 10, "busy_s": 4.5, "window_s": 7.0}}
    assert spec.reader(root, f"device_idle.{kind}")(s) == pytest.approx(10.0)
    mfu = 100.0 * 0.5e15 / (5.0 * work.PEAK_FLOPS)
    assert spec.reader(root, f"mfu.{kind}")(s) == pytest.approx(mfu)
