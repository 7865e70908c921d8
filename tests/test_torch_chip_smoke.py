"""chip_smoke.py's kernel checks at tiny latents on the CPU, where every
wrapper runs its plain version: each case must pass its own check, and each
planted fault (zeroed attention, half the keys, kernel 1's softmax scale
applied twice, kernel 2's heads mis-packed, kernel 3's value and gate
halves swapped, kernel 4's taps reversed and its
one-pass variance at a DC offset; for the backward kernels delta dropped,
the softmax Jacobian's row-sum term dropped, the g * pdf(g) term dropped)
must fail it. This holds the checks' power to see a wrong
kernel, not the kernels themselves (those run only on the card)."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
import mudg_tpu_torch.kernels as K
from mudg_tpu_torch.nn import attention as nn_att
from mudg_tpu_torch.nn import unet3d as U

# kernel 13 composites splats; no UNet forward or training step reaches it.
# Kernels 11 and 12 run only on the switch path, checked by phase 11.
GS_KERNELS = {"tile_composite", "tile_composite_bwd"}
SWITCH_KERNELS = set(CS.SWITCH_KERNELS)


@pytest.mark.parametrize("config", ["mdm512", "mdm1024"])
def test_chip_smoke_checks_see_planted_faults(config):
    """Every forward kernel's cases at a configuration; kernel 5 in bf16
    (MDM1024 only: no MDM512 bf16 forward reaches it) and in fp32 at every
    length an fp32 forward gives it (ds1 and ds2, and ds4 at MDM1024), held
    to F32_TOL and F32_LSE_TOL with three TF32 products per product in its
    bound and one more planted fault, "1xTF32";
    kernel 2 at MDM512 also at a tail shape (rows % 128 == 64, sites 0);
    kernel 4 at MDM512 also at a DC offset of 1e3 against float64, where
    only that case's kernel (here the bf16 plain version) may differ from
    its reference. Each kernel's yardsticks compute their part of its
    work."""
    seen, flash, faults, offsets, tails, f32_labels = set(), set(), {}, 0, [], set()
    # cases are consumed one by one: their closures bind the current inputs
    for case in CS.kernel_cases(torch, K, nn_att, (config,), dev="cpu",
                                latent={config: (8, 8)}):
        chk = CS.compare(torch, case)
        offset = "offset" in case.label
        offsets += offset
        assert chk.err <= (CS.TOL * chk.scale if offset else 0.0), (case.label, chk)
        assert chk.scale > 0.0, (case.label, chk)
        assert chk.lse_err in (None, 0.0), (case.label, chk)
        for name, err in chk.faults.items():
            # one TF32 product is held to the fp32 tolerance, the others miss bf16's too
            tol = CS.F32_TOL if name == "1xTF32" else CS.TOL
            assert err > tol * chk.scale, (case.label, name, err, chk.scale)
        assert chk.ok
        seen.add(case.name)
        faults.setdefault(case.name, set()).update(chk.faults)
        shapes = {k: fn() for k, fn in case.yardsticks.items()}
        if case.name == "geglu_ff":   # the cuBLAS yardstick: x W1^T and h W2^T alone
            m, c = map(int, case.label.split()[-1].split("x"))
            assert [tuple(p.shape) for p in shapes["cublas_gemm_ms"]] == [(m, 8 * c), (m, c)]
        elif case.name == "spatial_attn":   # the core alone in SDPA, (B, H, L, 64)
            b, l, c = map(int, case.label.split()[-1].split("x"))
            assert tuple(shapes["sdpa_core_ms"].shape) == (b, c // 64, l, 64)
        elif case.name == "temporal_attn":   # both stages' xn Wqkv^T and o Wo^T alone
            rows, c = map(int, case.label.split()[-1].split("x"))
            assert [tuple(p.shape) for p in shapes["cublas_gemm_ms"]] == [
                (rows, 3 * c), (rows, c)] * 2
            if case.label.startswith("tail"):
                assert rows % 128 == 64 and case.sites == 0, case.label
                tails.append(case.label)
        elif case.name == "gn_silu_tconv":   # (M, 3C) taps by wcat: (M, C)
            assert case.reruns, case.label
            b, t, h, w, c = map(int, case.label.split()[1].split("x"))
            assert tuple(shapes["cublas_tap_gemm_ms"].shape) == (b * t * h * w, c)
        else:
            assert not shapes, case.label
        assert set(shapes) <= set(CS.YARDSTICKS)
        adds_residual = (case.name in ("spatial_attn", "temporal_attn")
                         or case.label.startswith("block"))
        assert (case.base is not None) == adds_residual, case.label
        if case.name == "flash_attention":
            f32 = case.label.startswith("f32")
            assert (case.tol, case.lse_tol, case.peak) == (
                (CS.F32_TOL, CS.F32_LSE_TOL, CS.PEAK_TF32) if f32 else
                (CS.TOL, CS.LSE_TOL, CS.PEAK_FLOPS)), case.label
            assert set(chk.faults) == ({"half the keys", "1xTF32"} if f32 else
                                       {"half the keys"}), case.label
            assert case.sites == (5 if case.label.startswith("ds4") else 0), case.label
            flash.add(f32)
            if f32:
                f32_labels.add(case.label.split()[1])
    forward = {n for n in K.KERNELS if not n.endswith("_bwd")} - GS_KERNELS - SWITCH_KERNELS
    assert seen == forward
    assert flash == ({True} if config == "mdm512" else {False, True})
    assert f32_labels == ({"ds1", "ds2"} if config == "mdm512" else {"ds1", "ds2", "ds4"})
    assert faults["spatial_attn"] == {"zero attention", "half the keys", "softmax scale twice"}
    assert faults["temporal_attn"] == {"zero attention", "mis-packed heads"}
    assert faults["geglu_ff"] == {"gate and value swapped"}
    assert len(tails) == (config == "mdm512")
    assert faults["gn_silu_tconv"] == (
        {"taps reversed", "one-pass variance"} if config == "mdm512" else {"taps reversed"})
    assert offsets == (config == "mdm512")


def test_chip_smoke_kernel_line_keys():
    """The JSON kernel line: every kernel with the contract's keys and the
    yardsticks (kernel 3's products and kernel 4's product alone in cuBLAS,
    kernel 1's core alone in SDPA, each alone and queued) beside its plain
    time (null elsewhere), the library call's queued time beside the
    kernel's, launches summed over the main paths, the redesigned kernels'
    sources."""
    rows = {"geglu_ff": {"max_abs_err": 0.01, "ms": 2.0, "plain_ms": 3.0, "bound_ms": 1.0,
                         "bound_by": "operations", "library_ms": None,
                         "cublas_gemm_ms": 1.5, "shapes": []},
            "short_kv_attention": {"ms": 0.8, "ms_queued": 0.5, "library_ms": 0.6,
                                   "library_ms_queued": 0.55, "shapes": []},
            "spatial_attn": {"ms": 9.0, "sdpa_core_ms": 4.0, "sdpa_core_ms_queued": 3.9,
                             "shapes": []},
            "gn_silu_tconv": {"ms": 2.0, "cublas_tap_gemm_ms": 1.0, "shapes": []}}
    launches = {"a": dict.fromkeys(K.KERNELS, 1), "b": dict.fromkeys(K.KERNELS, 2)}
    line = CS.kernel_line(K.KERNELS, rows, launches)["kernels"]
    assert [k["name"] for k in line] == list(K.KERNELS)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "ms_queued",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "library_ms_queued",
            "cublas_gemm_ms", "cublas_gemm_ms_queued", "sdpa_core_ms", "sdpa_core_ms_queued",
            "cublas_tap_gemm_ms", "cublas_tap_gemm_ms_queued"}
    for k in line:
        assert keys <= set(k) and k["launches"] == 3 and k["route"] == "cuda"
    by = {k["name"]: k for k in line}
    assert by["geglu_ff"]["cublas_gemm_ms"] == 1.5 and by["geglu_ff"]["plain_ms"] == 3.0
    assert by["spatial_attn"]["cublas_gemm_ms"] is None
    assert (by["spatial_attn"]["sdpa_core_ms"], by["spatial_attn"]["sdpa_core_ms_queued"]
            ) == (4.0, 3.9)
    assert by["gn_silu_tconv"]["cublas_tap_gemm_ms"] == 1.0
    assert by["geglu_ff"]["sdpa_core_ms"] is None
    assert (by["short_kv_attention"]["ms_queued"], by["short_kv_attention"]["library_ms_queued"]
            ) == (0.5, 0.55)
    assert by["geglu_ff"]["source"] == "mudg_tpu_torch/csrc/geglu_ff.cu"
    assert by["short_kv_attention"]["source"] == (
        "mudg_tpu_torch/csrc/short_kv.cu,mudg_tpu_torch/csrc/short_kv_f32.cu")


def test_chip_smoke_grad_checks_see_planted_faults():
    """Every backward kernel's cases (kernel 6 in bf16 at each training
    length, in fp32 at MDM512 ds1 and ds2 held to F32_BWD_TOL with the
    "1xTF32" fault and three TF32 products per product in its bound, and at
    the 576-row tail shape in both dtypes; kernels 6, 9 and 10 each rerun
    bit for bit), with kernel 5 before each of kernel 6's: each passes its
    check and each planted fault misses it. Kernel 10's yardstick computes
    its six products alone, kernel 9's its five per stage for both
    stages."""
    seen, flash_bwd = set(), []
    for case in CS.grad_cases(torch, K, nn_att, dev="cpu",
                              latent={"mdm512": (8, 8), "mdm1024": (8, 16)}):
        chk = CS.compare(torch, case)
        assert chk.err == 0.0 and chk.ok, (case.label, chk)
        bound = case.grad_tol if case.grads else case.tol * chk.scale
        assert chk.faults and all(e > bound for e in chk.faults.values()), (case.label,
                                                                            chk.faults)
        assert CS.reruns_bit_for_bit(torch, case)
        assert case.reruns == (case.name in ("flash_attention_bwd", "temporal_attn_bwd",
                                             "geglu_ff_bwd")), case.label
        if case.name == "geglu_ff_bwd":   # x W1v^T, x W1g^T, dy W2, [du | dg] W1, dy^T h, [du | dg]^T x
            m, c = map(int, case.label.split("x"))
            assert [tuple(p.shape) for p in case.yardsticks["cublas_gemm_ms"]()] == [
                (m, 4 * c), (m, 4 * c), (m, 4 * c), (m, c), (c, 4 * c), (8 * c, c)]
        elif case.name == "temporal_attn_bwd":   # per stage: xn Wqkv'^T, dy Wo, dqkv^T xn,
            m, c = map(int, case.label.split()[-1].split("x"))   # dy^T o, dqkv Wqkv'
            assert [tuple(p.shape) for st in case.yardsticks["cublas_gemm_ms"]() for p in st] == [
                (m, 3 * c), (m, c), (3 * c, c), (c, c), (m, c)] * 2
        else:
            assert not case.yardsticks, case.label
        if case.name == "flash_attention_bwd":
            flash_bwd.append((case.config, case.label.split()[-1], case.grad_tol))
            f32 = case.grad_tol == CS.F32_BWD_TOL
            assert case.peak == (CS.PEAK_TF32 if f32 else CS.PEAK_FLOPS), case.label
            assert ("1xTF32" in chk.faults) == f32, case.label
        seen.add(case.name)
    assert [c for c, _, tol in flash_bwd if tol == CS.F32_BWD_TOL] == [
        "mdm512-f32", "mdm512-f32", "tail-f32"]
    assert ("tail", "3x576x3x64", CS.BWD_TOL) in flash_bwd
    assert ("tail-f32", "3x576x3x64", CS.F32_BWD_TOL) in flash_bwd
    assert sum(c in ("mdm512", "mdm1024") for c, _, _ in flash_bwd) == 5
    # kernel 5's forward at each training length, before kernel 6 there
    assert seen == ({n for n in K.KERNELS if n.endswith("_bwd")} - GS_KERNELS) | {"flash_attention"}


def test_chip_smoke_gs_checks_see_planted_faults():
    """Phase 9's kernel 13 checks at tiny scenes (a)-(d): kernel and plain
    agree exactly here (the wrapper runs the plain version on the CPU), the
    backward reruns bit for bit, and each planted fault (pairs composited
    back to front; the backward without its occlusion term) misses its
    bound."""
    from mudg_tpu_torch.gs import gaussians as G
    from mudg_tpu_torch.gs import tile_raster as TT
    from mudg_tpu_torch.kernels import tile_raster as KT

    npays = []
    for case in CS.gs_cases(torch, G, dev="cpu", n_scale=1e-3, res_scale=8):
        r = CS.gs_check(torch, KT, G, TT, case)
        assert r["ok"] and r["bitwise"], (case.label, r)
        assert r["fwd_err"] == 0.0 and r["bwd_err"] == 0.0, case.label
        assert set(r["faults"]) == {"back to front", "occlusion term dropped"}
        assert all(v > 1.0 for v in r["faults"].values()), (case.label, r["faults"])
        assert r["pairs"] > 0 and r["evals_fwd"] >= r["evals_bwd"] >= r["contributions"] > 0
        assert r["plain_ms"] is None and r["plain_bwd_ms"] is None   # timed on the card only
        npays.append(r["npay"])
    assert npays == [4, 4, 4, 23]


def test_chip_smoke_norm_short_checks_see_planted_faults():
    """Phase 11's checks of kernels 11 and 12 at tiny shapes on the CPU,
    where each wrapper runs its plain version: every case passes its own
    check (GN, LN and short-KV in fp32 within 1e-5 * max|ref|, the fp32 GroupNorm at a DC offset of 1e3 against the plain
    version in float64, within 1e-5 * max|ref|), each planted fault (GN
    with the one-pass variance at the offset and with the group map shifted
    by one channel, LN without its mean, short-KV with the padded keys
    unmasked and with half the keys, fp32 short-KV on operands rounded once
    to TF32, packed with another sequence's keys) misses the bound, fp32
    short-KV is bound at three TF32 products per product and reruns bit for
    bit, GN and LN rerun once, and each autograd op's gradients pass theirs."""
    from mudg_tpu_torch.kernels import norms as N
    from mudg_tpu_torch.kernels import short_attention as SA

    seen, faults = set(), set()
    cases = CS.norm_short_cases(
        torch, N, SA, dev="cpu",
        gn={"mdm512": {(2, 4, 8, 64): 1, (2, 2, 4, 8, 64): 1}, "mdm512-f32": {(2, 4, 8, 64): 0}},
        ln={"mdm512": {(2, 16, 64): 1}, "mdm512-f32": {(2, 16, 64): 0}},
        skv={"mdm512": {((2, 256, 2, 64), (2, 77, 2, 64)): 1,
                        ((2, 256, 2, 64), (2, 16, 2, 64)): 1},
             "mdm512-f32": {((2, 256, 2, 64), (2, 77, 2, 64)): 0}},
        packed=((8, 16, 2, 64), (16, 8, 2, 128)), offset_shape=(2, 4, 8, 64))
    for case in cases:
        chk = CS.compare(torch, case)
        assert chk.ok, (case.name, case.label, chk)
        if case.grads:
            assert chk.err <= CS.BWD_TOL
        elif "offset" not in case.label:
            assert chk.err == 0.0 and chk.scale > 0.0, (case.label, chk)
        for name, err in chk.faults.items():
            assert err > chk.tol * chk.scale, (case.label, name, err, chk.scale)
            faults.add((case.name, name))
        assert CS.reruns_bit_for_bit(torch, case)
        f32_skv = case.name == "short_kv_attention" and case.tol == CS.F32_TOL
        assert case.reruns == (0 if case.grads else CS.SKV_RERUNS if f32_skv
                               else int(case.name in ("group_norm", "layer_norm"))), case.label
        assert (case.peak == CS.PEAK_TF32) == (f32_skv and not case.grads), case.label
        seen.add((case.name, case.grads, case.tol))
    assert {n for n, _, _ in seen} == SWITCH_KERNELS
    assert {n for n, g, _ in seen if g} == SWITCH_KERNELS          # every op's gradients
    assert {n for n, _, tol in seen if tol == CS.F32_TOL} == {"group_norm", "layer_norm",
                                                              "short_kv_attention"}
    assert faults == {("group_norm", "one-pass variance"),
                      ("group_norm", "groups shifted by one channel"),
                      ("layer_norm", "mean not subtracted"),
                      ("short_kv_attention", "padded keys unmasked"),
                      ("short_kv_attention", "half the keys"),
                      ("short_kv_attention", "1xTF32"),
                      ("packed_short_attention", "another sequence's keys")}


def test_chip_smoke_switch_launch_expectations():
    """Phase 12's expected launches: kernels 1-5 at their sites and kernels
    11-12 at SWITCH_SITES per UNet forward; the clip adds the resampler's
    LayerNorms; the micro-step adds the forward's and the remat recompute's
    sites to phase 7's; with the switches unset every path expects none."""
    clip = CS.switch_clip_launches()
    assert clip["group_norm"] == 25 * CS.SWITCH_SITES["mdm1024"]["group_norm"]
    assert clip["layer_norm"] == 25 * 56 + 9
    assert clip["flash_attention"] == 125 and clip["packed_short_attention"] == 0
    micro = CS.switch_train_launches()
    assert micro["group_norm"] == 117 + 86 and micro["short_kv_attention"] == 20
    assert {k: micro[k] for k in CS.TRAIN_SITES["mdm512"]} == \
        {k: v for k, v in CS.train_launches("mdm512", 1).items() if k in CS.TRAIN_SITES["mdm512"]}
    for cfg in ("mdm512", "mdm1024"):
        assert all(CS.SITES[cfg][k] == 0 for k in CS.SWITCH_KERNELS)
    assert all(v == 0 for k, v in CS.train_launches("mdm512", 2).items() if k in CS.OFF)


def test_chip_smoke_tf32_bound():
    """fp32 flash attention's bound: three TF32 products per product at 495
    TFLOP/s (the MDM512 ds1 forward, 32 x 2560 x 5 heads, 268.4 GFLOP:
    1.627 ms), the FMA bound at 67 TFLOP/s beside it (4.007 ms); the bf16
    and FMA bounds are unchanged."""
    flops, nbytes = CS.work_flash(32, 2560, 5, 64, 4)
    assert flops == pytest.approx(268.4e9, rel=1e-3)
    ms, by = CS.bound(flops, nbytes, CS.PEAK_TF32)
    assert by == "operations" and ms == pytest.approx(3e3 * flops / 495e12)
    assert ms == pytest.approx(1.627, abs=1e-3)
    assert CS.bound(flops, nbytes, CS.PEAK_FP32)[0] == pytest.approx(4.007, abs=1e-3)
    assert CS.bound(flops, nbytes)[0] == pytest.approx(1e3 * flops / 989e12)
    bflops, bbytes = CS.work_flash_bwd(16, 2560, 5, 64, 4)
    assert CS.bound(bflops, bbytes, CS.PEAK_TF32)[0] == pytest.approx(2.033, abs=1e-3)


def test_device_time_per_call_leaves_out_calls_the_profiler_dropped():
    """Kernel 11's device time per call (phases 2 and 11 with --profile):
    each kernel belongs to the call whose range is nearest its start (a
    device clock placed a few us late does not move it to the next call),
    a call that lost kernels to the profiler is left out, and a profile
    with no kernel raises. Here kernel 2's two LN launches per call, one of
    them dropped from the second call, the third call's last kernel placed
    past its range, then the first call's 150 us past its own."""
    spans = [(0.0, 100.0), (2100.0, 2200.0), (4200.0, 4300.0)]
    ln = "void mudg::ln_row_kernel<__nv_bfloat16, float, 2>(...)"
    gemm = "void mudg::wgmma_gemm_kernel<3>(...)"
    kernels = [(ln, 1.0, 4.0), (gemm, 6.0, 20.0), (ln, 30.0, 4.0),
               (ln, 2101.0, 4.0), (gemm, 2106.0, 20.0),
               (ln, 4201.0, 6.0), (gemm, 4206.0, 20.0), (ln, 4305.0, 6.0)]
    got = CS.per_call_device_ms(spans, kernels)
    assert got["calls_held"] == 2 and got["norm_launches"] == 2.0
    assert got["device_ms"] == pytest.approx((28.0 + 32.0) / 2 / 1e3)
    assert got["norm_device_ms"] == pytest.approx((8.0 + 12.0) / 2 / 1e3)
    assert got["norm_launch_ms"] == pytest.approx(20.0 / 4 / 1e3)
    # a kernel placed well into the gap after its call still belongs to it
    late = [(ln, 250.0, 4.0) if k == (ln, 30.0, 4.0) else k for k in kernels]
    assert CS.per_call_device_ms(spans, late) == got
    with pytest.raises(RuntimeError):
        CS.per_call_device_ms(spans, [])


# ---------------------------------------------------------------------------
# Phase 14, the serving path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["mdm512", "mdm1024"])
def test_chip_smoke_batch6_shapes_are_the_traced_ones(config):
    """Phase 14 (b)'s cases: the kernel calls of one full-width UNet forward
    at the serving batch, bf16 and fp32, traced on the meta device, are
    exactly forward_keys' shapes; none of them is a batch-2 shape, and no
    shape that only phase 2 checks (tail, long) is among them."""
    traced = CS.traced_kernel_keys(torch, K, U, config, CS.SERVE_BATCH)
    assert traced == CS.forward_keys(config, CS.SERVE_BATCH)
    assert not traced & CS.forward_keys(config, 2)
    assert {k[0] for k in traced} == {"spatial_attn", "temporal_attn", "geglu_ff",
                                      "geglu_ff_block", "gn_silu_tconv", "flash_attention"}
    shapes = CS.forward_shapes(config, CS.SERVE_BATCH)
    assert all(label not in ("tail", "long") for label, *_ in shapes["temporal"] + shapes["flash"])


@pytest.mark.parametrize("config", ["mdm512", "mdm1024"])
def test_chip_smoke_batch6_checks_see_planted_faults(config):
    """Phase 14 (b)'s cases at tiny latents: 96 frames a case, each passing
    its check with every planted fault missing it; no DC-offset case."""
    labels = set()
    for case in CS.kernel_cases(torch, K, nn_att, (config,), dev="cpu",
                                latent={config: (8, 8)}, batch=CS.SERVE_BATCH):
        chk = CS.compare(torch, case)
        assert chk.ok and chk.err == 0.0 and chk.scale > 0.0, (case.label, chk)
        assert chk.faults and all(err > (CS.F32_TOL if n == "1xTF32" else CS.TOL) * chk.scale
                                  for n, err in chk.faults.items()), (case.label, chk.faults)
        labels.add(case.label)
    assert "ds1 96x64x320" in labels and "ds1 6x16x8x8x320" in labels
    assert not any("offset" in lb or lb.startswith(("tail", "long")) for lb in labels)


def test_chip_smoke_serving_checks(monkeypatch):
    """Phase 14 (c)'s checks on the CPU without OpenCV: render_windows on
    the tiny MDM (fp32, random weights, 2 steps) over two seeded windows of
    4 frames at 32x64 passes the carry check; its UNet forwards are what
    serve_launches counts, batched and task_serial; the planted faults, frame
    0 not re-anchored to the GT and the first half carried, fail the carry
    check."""
    import sys

    from mudg_tpu_torch.apps import render_infer as RI
    from mudg_tpu_torch.models import mdm as TMDM
    from mudg_tpu_torch.models import presets as TP

    monkeypatch.setitem(sys.modules, "cv2", None)   # the device loop runs without OpenCV
    gen = torch.Generator().manual_seed(0)
    mdm = CS.randomize_(torch, TMDM.init_mdm(TP.tiny(), gen), gen).eval()
    forwards = []
    unet_forward = mdm.unet.forward
    monkeypatch.setattr(mdm.unet, "forward",
                        lambda *a, **k: forwards.append(1) or unet_forward(*a, **k))
    steps, vl = 2, 4
    sample_fn = RI.build_sampler(steps=steps, dtype=torch.float32)
    windows = CS.serve_windows(2, 5, clip=(vl, 32, 64))
    tokens = torch.randint(0, 49408, (3, 77), generator=gen)
    for task_serial in (False, True):
        forwards.clear()
        used, outs = [], []
        for _, sparse, out in RI.render_windows(
                mdm, sample_fn, windows, tokens=tokens, null_tokens=tokens[0],
                video_length=vl, generator=torch.Generator().manual_seed(1),
                task_serial=task_serial):
            assert out.shape == (3, vl, 32, 64, 3) and np.isfinite(out).all()
            used.append(sparse)
            outs.append(out)
        assert len(forwards) == CS.serve_launches({"unet": 1}, steps, 2, task_serial)["unet"]
        CS.check_carry(windows, used, outs, vl)
    assert CS.serve_launches(CS.SITES["mdm512"], 25, 2, False)["geglu_ff"] == 2 * 25 * 33
    assert CS.serve_launches(CS.SITES["mdm512"], 25, 1, True)["spatial_attn"] == 3 * 25 * 10
    half = vl // 2
    no_anchor = [u.copy() for u in used]
    no_anchor[1][0] = outs[0][0, half]
    first_half = [u.copy() for u in used]
    first_half[1][:half] = outs[0][0, :half]
    first_half[1][0] = windows[1]["frame0"]
    for fault in (no_anchor, first_half):
        with pytest.raises(AssertionError, match="carry"):
            CS.check_carry(windows, fault, outs, vl)


def test_chip_smoke_checkpoint_path():
    """Phase 14 (d) on the CPU at the tiny UNet: seeded random weights
    through an in-memory fp16 MuDG .ckpt and the port's reader, strictly
    into a served UNet, cast to bf16 and packed; the kernel path (here the
    plain one) within phase 3's gate of the fp32 path of the same weights."""
    from mudg_tpu_torch.apps import render_infer as RI
    from mudg_tpu_torch.models import presets as TP
    from mudg_tpu_torch.train import checkpoint as TC

    cfg = TP.tiny().unet
    gen = torch.Generator().manual_seed(3)
    with torch.device("meta"):
        unet = U.UNet3D(cfg)
    unet.to_empty(device="cpu")
    b, t = 6, cfg.temporal_length
    x = torch.randn((b, t, 8, 8, cfg.in_channels), generator=gen)
    ctx = torch.randn((b, 77 + t * cfg.image_tokens_per_frame, cfg.context_dim), generator=gen)
    ts = torch.full((b,), 700)
    lab = torch.zeros(b, dtype=torch.int64)
    fs = torch.full((b,), 10)
    report, counts = CS.check_ckpt_load(torch, K, RI, TC, unet, x, ts, ctx, lab, fs)
    assert next(unet.parameters()).dtype == torch.bfloat16
    assert report["rel_l2_kernels"] == report["rel_l2_plain_bf16"] < 0.05
    assert sum(counts.values()) == 0


def _waymo_items(scene, tmp_path):
    """Items over a copy of the synthetic scene (the caches written beside
    its frames stay out of the worker's shared scene, whose caches
    tests/test_latents.py counts), their moment caches at 32x64 (a tiny
    random VAE)."""
    import shutil

    from mudg_tpu_torch.data import latents as TL
    from mudg_tpu_torch.data import waymo as TW
    from mudg_tpu_torch.models import mdm as TMDM
    from mudg_tpu_torch.models import presets as TP
    from test_torch_apps import scene_items

    path = scene_items(shutil.copytree(scene, tmp_path / "scene"), tmp_path / "items.txt", 2)
    vae = TMDM.init_mdm(TP.tiny(), torch.Generator().manual_seed(0), "cpu").vae
    TL.precompute(TW.read_items(path), vae, (32, 64), batch=4, skip_existing=False, log=None)
    return path


def _same_layout(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if isinstance(v, np.ndarray):
            assert (ours[k].shape, ours[k].dtype) == (v.shape, v.dtype), k
        else:
            assert type(ours[k]) is type(v), k


def test_chip_smoke_app_clips_are_waymo_items(scene, tmp_path):
    """Phase 15's SeededClips give WaymoDataset.load_item's keys, shapes and
    dtypes (pixels) and load_item_latents' (moments), and batch through the
    port's BatchLoader into its (accum, B, ...) batches."""
    from mudg_tpu_torch.data import waymo as TW

    path = _waymo_items(scene, tmp_path)
    clip = (4, 32, 64)
    ds = TW.WaymoDataset(path, video_length=4, resolution=clip[1:], seed=0)
    for i, task in enumerate(("color", "semantic", "depth")):
        item = CS.SeededClips(3, clip=clip).load_item(i)
        _same_layout(item, ds.load_item(0, task))
        assert item["class_label"] == TW.CLASS_LABELS[task]
        assert all(item[k].min() >= -1 and item[k].max() <= 1
                   for k in ("dense_frames", "sparse_frames", "sparse_depth"))
    lat = TW.WaymoDataset(path, video_length=4, resolution=clip[1:], seed=0,
                          latents=True).load_item(0, "depth")
    frames = np.zeros((2, *clip[1:], 3), np.float32)
    clips = CS.SeededClips(2, clip=clip, moments=lat["dense_moments"].astype(np.float16),
                           frames=frames)
    _same_layout(clips.load_item(1), lat)
    batch = next(iter(TW.BatchLoader(clips, 1, accum_steps=2, prefetch=2)))
    assert batch["dense_moments"].shape == (2, 1, *lat["dense_moments"].shape)
    assert CS.SeededClips(2).load_item(0)["dense_frames"].shape == (*CS.APP_CLIP, 3)


@pytest.mark.parametrize("policy", [False, *CS.REPLAYED])
def test_chip_smoke_policy_launches_follow_the_sites(policy):
    """Phase 15's per-policy expectations: each forward kernel once per
    TRAIN_SITES site, again at every site but init_attn's where the policy
    replays it; each backward kernel once per site; the app's runs add the
    validation forwards and the sample's fp32 flash sites."""
    sites, init = CS.TRAIN_SITES["mdm512"], CS.INIT_ATTN_SITES
    got = CS.policy_launches("mdm512", policy, 2)
    for k, v in sites.items():
        again = policy and k in CS.REPLAYED[policy]
        assert got[k] == 2 * (v + (v - init.get(k, 0) if again else 0))
        assert got[k + "_bwd"] == 2 * v
    assert sum(v for k, v in got.items() if k not in sites and not k.endswith("_bwd")) == 0
    if policy == "dots_attn":
        assert {k: got[k] for k in sites} == {"flash_attention": 20, "temporal_attn": 12,
                                              "geglu_ff": 62}
    if policy == "full":
        assert got == CS.train_launches("mdm512", 2)
        assert {k: got[k] for k in sites} == {"flash_attention": 40, "temporal_attn": 22,
                                              "geglu_ff": 122}
    app = CS.app_launches("dots_attn", 4, val_forwards=4, sample_forwards=10)
    micro = CS.policy_launches("mdm512", "dots_attn", 8)
    assert app["flash_attention"] == micro["flash_attention"] + 4 * 10 + 10 * 10
    assert app["geglu_ff_bwd"] == micro["geglu_ff_bwd"]


@pytest.mark.parametrize("fault", [False, True])
def test_chip_smoke_launch_check_sees_a_replaying_dots_attn(monkeypatch, fault):
    """A dots_attn whose replay launches kernel 5's forward again (its
    outputs not kept) must fail phase 15's launch check; the port's own
    passes it. Launches counted on the meta device: each forward wrapper's
    plain version and each backward wrapper per site."""
    from mudg_tpu_torch.nn import remat as R
    from test_torch_remat import _port_kernel_forwards

    if fault:
        keeps = R._keeps
        monkeypatch.setattr(R, "_keeps", lambda rule, groups: (
            False if groups == (("attn_o",), ("attn_lse",)) else keeps(rule, groups)))
    calls = _port_kernel_forwards(monkeypatch, "dots_attn")
    expect = CS.policy_launches("mdm512", "dots_attn")
    counts = dict(expect)
    for k in CS.TRAIN_SITES["mdm512"]:
        counts[k] = calls["fwd"][k] + calls["bwd"].get(k, 0)
    if fault:
        assert counts["flash_attention"] == 20
        with pytest.raises(AssertionError, match="flash_attention"):
            CS.check_launches("(c) dots_attn", counts, expect)
    else:
        CS.check_launches("(c) dots_attn", counts, expect)


def test_chip_smoke_train_app_phase_on_the_cpu(monkeypatch):
    """Phase 15 (a)-(d) whole at the tiny preset, 4 frames of 32x64, on the
    CPU (torch.cuda's timing and memory calls stubbed): the app's records,
    files, SIGUSR1, the sample hook's restore, the resume bit for bit, every
    policy's gradients, the moments' round trip, each launch check called
    with its expectation (the wrappers launch nothing here), the work
    directory gone."""
    import mudg_tpu_torch.models.mdm as mdm_mod

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    for fn in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: 0)
    checked = {}
    monkeypatch.setattr(CS, "check_launches",
                        lambda what, counts, expect: checked.setdefault(what, expect))
    with torch.no_grad():   # as chip_smoke.main runs its phases
        launches, report = CS.phase_train_app(torch, K, mdm_mod, "cpu", dev="cpu",
                                              clip=(4, 32, 64), preset="tiny")
    assert not os.path.exists(os.path.join(CS.ROOT, "_phase15"))
    assert set(launches) == {"train_app", "train_app_resume", "remat_policies",
                             "train_app_latents"}
    assert checked["(a) the app loop"] == CS.app_launches("dots_attn", 4, val_forwards=4,
                                                          sample_forwards=10)
    assert checked["(b) resume"] == CS.app_launches("dots_attn", 2)
    assert checked["(c) dots_attn"] == CS.policy_launches("mdm512", "dots_attn")
    assert len([k for k in checked if k.startswith("(c)")]) == len(CS.REMAT_POLICIES)
    assert [r["step"] for r in report["b"]["records"]] == [3, 4]
    assert all(r["bit_equal"] for r in report["c"].values())
    assert sorted(report["a"]["artifacts"]) == ["final", "step_2", "trainstate_2"]


def _stub_card(monkeypatch):
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    for fn in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: 0)
    checked = {}
    monkeypatch.setattr(CS, "check_launches",
                        lambda what, counts, expect: checked.setdefault(what, expect))
    return checked


def _group_of_one(tmp_path):
    """A gloo group of one rank (FileStore rendezvous) for phase 16, which
    uses a group formed before it as it is."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)


def test_chip_smoke_parallel_phase_on_the_cpu(monkeypatch, tmp_path):
    """Phase 16 whole at the tiny preset (4 frames of 32x64) over a gloo
    group of one rank: the
    data-parallel step bit for bit equal to the one-process step, its
    planted fault (the gradients averaged twice) missing by the gradient
    norm's factor 2, FSDP within the gates, the SP and TP forwards and the
    SP sample checked; each launch check called with the training sites x
    micro-steps (the wrappers launch nothing here)."""
    import torch.distributed as dist

    import mudg_tpu_torch.models.mdm as mdm_mod
    from mudg_tpu_torch.train import step as step_mod

    checked = _stub_card(monkeypatch)
    _group_of_one(tmp_path)
    try:
        with torch.no_grad():   # as chip_smoke.main runs its phases
            launches, report = CS.phase_parallel(torch, K, mdm_mod, step_mod, dev="cpu",
                                                 preset="tiny", hw=(32, 64))
    finally:
        dist.destroy_process_group()
    assert set(launches) == {"parallel_dp", "parallel_fsdp"}
    want = CS.policy_launches("mdm512", "dots_attn", 2)
    assert checked == {"(a) data parallel": want, "(b) FSDP": want}
    assert report["dp_zero2"]["errors"]["bit_equal"]
    assert report["dp_zero2"]["zero_leaves"] and report["fsdp"]["fsdp_leaves"]
    assert abs(report["dp_fault"]["errors"]["grad_norm"] - 0.5) < 1e-6
    assert report["forward"]["sp"]["bit_equal"] and report["sample"]["sp"]["bit_equal"]
    for path in ("sp", "tp"):   # phase 3's gate against the fp32 forward
        assert (report["forward"][path]["rel_l2_vs_f32"]
                <= 1.5 * report["forward"]["plain"]["rel_l2_vs_f32"] + 5e-3)


def test_chip_smoke_parallel_phase_fails_on_a_planted_fault(monkeypatch, tmp_path):
    """With every gradient all-reduce dividing twice (over the data ranks
    and again over the microbatches), phase 16's data-parallel check
    fails."""
    import torch.distributed as dist

    import mudg_tpu_torch.models.mdm as mdm_mod
    from mudg_tpu_torch.parallel import mesh as PM
    from mudg_tpu_torch.train import step as step_mod

    _stub_card(monkeypatch)
    reduce = PM.Buckets.all_reduce
    monkeypatch.setattr(PM.Buckets, "all_reduce",
                        lambda self, t, g, divide=1.0: reduce(self, t, g, 2.0 * divide))
    _group_of_one(tmp_path)
    try:
        with torch.no_grad(), pytest.raises(AssertionError, match="data-parallel step differs"):
            CS.phase_parallel(torch, K, mdm_mod, step_mod, dev="cpu", preset="tiny",
                              hw=(32, 64))
    finally:
        dist.destroy_process_group()


def _tiny_int8_forwards(monkeypatch=None):
    from mudg_tpu_torch import quant as Q
    from mudg_tpu_torch.apps import render_infer as ri
    from test_torch_model import TINY_UNET

    with torch.no_grad():   # as chip_smoke.main runs its phases
        return CS.phase_quant_forwards(torch, K, Q, ri, U, "cpu", cfg=U.UNetConfig(**TINY_UNET),
                                       latent=(8, 8), dev="cpu", min_size=0)


def test_chip_smoke_int8_phase_on_the_cpu():
    """Phase 17 (a) and (b) at the tiny UNet (min_size 0, an 8x8 latent) on
    the CPU: every --quantize mode's forward at >= 15 dB against the bf16
    one, and at every int8 site of the int8 forward the accumulator equal
    to float64, the output within fp32 rounding and both planted faults
    missing (check_int8_sites raises otherwise)."""
    rep = _tiny_int8_forwards()
    assert set(rep["int8_sites"]) == set(CS.QUANT_OPS)
    faults = set()
    for v in rep["int8_sites"].values():
        assert v["max_excess"] <= 1.0 and v["sites"] > 0
        faults |= set(v["fault_min_excess"])
    assert faults == {"scale on input axis", "per-sample scale"}
    for mode in CS.QUANTIZE_MODES:
        assert rep[mode]["snr_db"] >= CS.QUANT_SNR_DB
    assert rep["int8"]["int8_bytes"] > rep["int8-conv"]["int8_bytes"] > 0
    assert rep["none"]["int8_bytes"] == 0


def test_chip_smoke_int8_check_sees_a_per_sample_conv(monkeypatch):
    """A port whose conv quantizes each sample on its own absmax (not the
    batch's, as JAX does) fails phase 17 (a): its accumulators differ."""
    from mudg_tpu_torch import quant as Q

    def per_sample(x):
        xf = x.float()
        return Q._quantize_act(xf, xf.abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True))

    monkeypatch.setattr(Q, "_dyn_quant_tensor", per_sample)
    with pytest.raises(AssertionError, match="accumulator differs"):
        _tiny_int8_forwards()


def test_chip_smoke_int8_serve_phase_on_the_cpu(monkeypatch, tmp_path):
    """Phase 17 (c) at the tiny preset (4 frames of 32x64, 1 step, min_size
    0) on the CPU: the --quantize int8-conv window and the artifact's, bit
    for bit; the work directory gone."""
    import mudg_tpu_torch.models.mdm as mdm_mod
    from mudg_tpu_torch.apps import quantize_ckpt as qa
    from mudg_tpu_torch.apps import render_infer as ri
    from mudg_tpu_torch.apps import serve as sv

    monkeypatch.setattr(CS, "ROOT", str(tmp_path))
    with torch.no_grad():
        launches, rep = CS.phase_quant_serve(torch, K, mdm_mod, ri, sv, qa, "cpu", dev="cpu",
                                             preset="tiny", small=(4, 32, 64, 1, 0))
    assert set(launches) == {"mdm512_serve_int8_conv", "mdm512_serve_int8_artifact"}
    assert rep["artifact_gb"] > 0 and not os.path.exists(tmp_path / "_phase17")


def test_chip_smoke_conditions_phase_on_the_cpu(monkeypatch):
    """Phase 17 (d) on a small scene (96x64, 20k points) on the CPU: the
    scene, both app runs, their comparison; and the comparison refuses a
    pixel that differs away from any rounding tie."""
    from mudg_tpu_torch.render import pointcloud as PC
    from mudg_tpu_torch.render import splat as SP

    small = dict(hw=(64, 96), n_points=20_000, objects=(2, 500), lidar=3000)
    rep = CS.phase_conditions(torch, "cpu", dev="cpu", **small)
    assert rep["outputs"] == 2 * 3 + 4 * 3 + 2 * 2 and rep["pixels_at_ties"] == 0
    import tempfile

    from mudg_tpu_torch.apps import make_conditions as mc
    from mudg_tpu_torch.utils import media

    with tempfile.TemporaryDirectory() as d:
        scene = CS.conditions_scene(d, **small)
        maps, _ = CS.run_conditions(mc, media, scene, "cpu")
        moved = {k: v.copy() for k, v in maps.items()}
        name = next(k for k in moved if k.startswith("depth") and k.endswith(".npy"))
        moved[name][5, 5] += 1.0
        with pytest.raises(AssertionError, match="no rounding tie"):
            CS.compare_conditions(torch, SP, PC, scene, moved, maps)


def test_chip_smoke_offline_phase_on_the_cpu(monkeypatch, tmp_path):
    """Phase 18 whole at tiny sizes on the CPU (a 32x48 frame, DepthLab with
    tests/test_depthlab.py's TINY UNets and VAE at 2 steps, SegFormer at B0
    widths with one block a stage, 2 eval pairs): segment's ids against
    float64's, densify's outputs and its rerun bit for bit, the four UNet
    paths' gates, eval's card rows against the CPU's and SSIM / LPIPS
    against float64; the work directory gone."""
    import dataclasses

    from mudg_tpu_torch.models import depthlab as DL
    from mudg_tpu_torch.models import sd_unet2d as SU
    from mudg_tpu_torch.models import segformer as S
    from mudg_tpu_torch.nn import vae as V

    checked = _stub_card(monkeypatch)
    monkeypatch.setattr(CS, "ROOT", str(tmp_path))
    tiny = dict(out_channels=4, block_out_channels=(16, 32), layers_per_block=1,
                cross_attention_dim=24, head_dim=8, norm_num_groups=4)
    dl = DL.DepthLabConfig(unet=SU.SDUNetConfig(in_channels=12, **tiny),
                           ref_unet=SU.SDUNetConfig(in_channels=4, **tiny),
                           vae=V.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
                           image_embed_dim=20)
    seg = dataclasses.replace(S.SegFormerConfig.b0(), depths=(1, 1, 1, 1))
    small = dict(hw=(32, 48), depthlab=dl, segformer=seg, steps=2, eval_hw=(32, 48), pairs=2)
    launches, rows, rep = CS.phase_offline(torch, K, nn_att, "cpu", dev="cpu", small=small)
    assert not os.path.exists(tmp_path / "_phase18") and rows == {}
    assert set(launches) == {"densify", "segment", "eval_color", "eval_semantic", "eval_depth"}
    assert set(checked) == {"segment", "eval color", "eval semantic", "eval depth"}
    assert rep["densify"]["unet_calls"] == 2 and rep["densify"]["steps"] == 2
    assert max(rep["segment"]["rel_l2_f64"]) <= CS.SEG_TOL
    unets = rep["unets"]
    assert unets["rel_l2_kernels_f32"] == 0.0   # no kernel on the CPU: the same ops
    assert rep["eval"]["lpips_rel_f64"] <= CS.EVAL_TOL
    assert set(rep["eval"]["summaries"]) == {"color", "semantic", "depth"}
