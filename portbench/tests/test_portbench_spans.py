"""The reduction of the program's own spans (`harness/spans.py`) on
synthetic trace events, and the readers of the metrics built on it."""
from __future__ import annotations

import pytest

from portbench.harness import spans, spec, work

from portbench.tests.helpers import ROOT

GEMM = "void mudg::wgmma_gemm_kernel<2, 0>"      # one device template, two kernels
FLASH = "void mudg::flash_fwd_kernel<false>"
GN = "void at::native::reduce_kernel<128, 4>"
COPY = "void at::native::elementwise_kernel<128, 4>"
SITES = {"spatial_attn": [(989e9, 0)], "geglu_ff": [(0, 3.35e9)]}   # 1 ms of work each


def window():
    """One sampler step (0-1200 ns) holding one UNet call: a ResBlock with
    a GroupNorm op, a spatial block whose kernel-1 call launches the shared
    GEMM template and the flash core (launch calls at 400 and 420 ns,
    correlations 10 and 12), a kernel-3 call launching the same GEMM
    template (correlation 11) and a copy launched by the UNet itself; then
    a decode and its copy. Each device op carries its launch call's
    correlation."""
    ranges = [("sampler.step", 0, 1200), ("unet", 10, 1000),
              ("unet.res", 20, 300), ("unet.spatial", 300, 700),
              ("kernel.spatial_attn", 400, 450), ("kernel.geglu_ff", 600, 650),
              ("vae.decode", 1300, 1600)]
    launchers = {1: 30, 10: 400, 12: 420, 11: 600, 2: 800, 3: 1400}
    ops = [(GN, 100, 200, 1),                     # glue of unet.res
           (GEMM, 450, 550, 10), (FLASH, 550, 580, 12),   # kernel 1
           (GEMM, 650, 900, 11),                  # kernel 3, the same template
           (COPY, 900, 960, 2),                   # glue of the unet itself
           (COPY, 1500, 1550, 3)]                 # outside the unet
    return ranges, launchers, ops


def test_kernels_split_by_their_spans_where_they_share_a_device_op():
    ranges, launchers, ops = window()
    r = spans.reduce(ranges, launchers, ops, 0, 2000)
    assert r["kernels"] == {"spatial_attn": {"s": pytest.approx(130e-9), "calls": 1},
                            "geglu_ff": {"s": pytest.approx(250e-9), "calls": 1}}
    assert r["port_s"] == pytest.approx(380e-9) == r["spanned_port_s"]


def test_glue_by_innermost_span_and_idle_gaps_by_the_span_open_at_their_start():
    ranges, launchers, ops = window()
    r = spans.reduce(ranges, launchers, ops, 0, 2000)
    assert r["unet"] == {"calls": 1, "device_s": pytest.approx(540e-9),
                         "glue_s": pytest.approx(160e-9)}
    assert r["glue_by_span"] == {"unet.res": pytest.approx(100e-9),
                                 "unet": pytest.approx(60e-9)}
    # idle: 0-100 (sampler.step open at 0), 200-450 (unet.res at 200),
    # 580-650 (unet.spatial at 580), 960-1500 (unet at 960), 1550-2000
    # (vae.decode at 1550)
    assert r["idle_gaps"] == {"sampler.step": pytest.approx(100e-9),
                              "unet.res": pytest.approx(250e-9),
                              "unet.spatial": pytest.approx(70e-9),
                              "unet": pytest.approx(540e-9),
                              "vae.decode": pytest.approx(450e-9)}


def test_window_clips_ops_and_counts_only_whole_spans():
    ranges, launchers, ops = window()
    r = spans.reduce(ranges, launchers, ops, 500, 1000)
    assert r["kernels"] == {"spatial_attn": {"s": pytest.approx(80e-9), "calls": 0},
                            "geglu_ff": {"s": pytest.approx(250e-9), "calls": 1}}
    assert r["unet"]["calls"] == 0
    # an op whose launch the trace lost goes to the spans open at its own start
    lost = [(COPY, 320, 330, 99)]
    assert spans.reduce(ranges, launchers, lost, 0, 2000)["glue_by_span"] == {
        "unet.spatial": pytest.approx(10e-9)}


def test_nest_innermost_and_names():
    nest = spans.Nest([("a", 0, 100), ("b", 10, 50), ("c", 20, 30), ("d", 60, 90)])
    assert nest.names(nest.innermost(25)) == ["c", "b", "a"]
    assert nest.names(nest.innermost(40)) == ["b", "a"]
    assert nest.names(nest.innermost(55)) == ["a"]
    assert nest.names(nest.innermost(70)) == ["d", "a"]
    assert nest.innermost(150) == -1 and nest.names(-1) == []


def summary():
    ranges, launchers, ops = window()
    return {"kind": "serve", "sites": SITES, "windows": 2,
            "program_trace": spans.reduce(ranges, launchers, ops, 0, 2000),
            "spans": {"windows": 2, "totals": {
                "render.sample/vae.encode": {"count": 96, "ns": 3_000_000},
                "render.sample/vae.decode": {"count": 48, "ns": 1_000_000},
                "render.sample": {"count": 2, "ns": 9_000_000}}}}


NEW = ("kernel_roofline.spatial_attn.serve", "kernel_roofline.temporal_attn.serve",
       "kernel_roofline.geglu_ff.serve", "kernel_roofline.gn_silu_tconv.serve",
       "kernel_roofline.flash_attention.serve", "unet_glue_ms.serve", "vae_host_ms.serve")


def test_readers():
    s = summary()
    read = {name: spec.reader(ROOT, name) for name in NEW}
    least = work.least_s(989e9, 0)
    assert read["kernel_roofline.spatial_attn.serve"](s) == pytest.approx(100 * least / 130e-9)
    assert read["kernel_roofline.geglu_ff.serve"](s) == pytest.approx(100 * least / 250e-9)
    assert read["unet_glue_ms.serve"](s) == pytest.approx(160e-6)
    assert read["vae_host_ms.serve"](s) == pytest.approx(2.0)
    # kernels that did not launch, and summaries without the program's spans
    # (a program that has none, a --trace 0 run, a training step)
    for name in ("kernel_roofline.temporal_attn.serve", "kernel_roofline.gn_silu_tconv.serve",
                 "kernel_roofline.flash_attention.serve"):
        assert read[name](s) is None
    for bare in ({}, {"kind": "serve"}, {**s, "kind": "train"},
                 {"kind": "serve", "sites": SITES, "program_trace": {}, "spans": None}):
        assert all(read[name](bare) is None for name in NEW)
