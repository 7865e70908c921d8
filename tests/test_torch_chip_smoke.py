"""chip_smoke.py's kernel checks at tiny latents on the CPU, where every
wrapper runs its plain version: each case must pass its own check, and each
planted fault (zeroed attention, half the keys, kernel 1's softmax scale
applied twice, kernel 2's heads mis-packed, kernel 4's taps reversed and its
one-pass variance at a DC offset; for the backward kernels delta dropped,
the softmax Jacobian's row-sum term dropped, the g * pdf(g) term dropped)
must fail it. This holds the checks' power to see a wrong
kernel, not the kernels themselves (those run only on the card)."""
from __future__ import annotations

import pytest
import torch

import chip_smoke as CS
import mudg_tpu_torch.kernels as K
from mudg_tpu_torch.nn import attention as nn_att

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
