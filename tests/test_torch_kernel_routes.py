"""Kernel 12's short-KV route (`kernels/short_attention.short_kv_route`) on
the CPU: which of its CUDA files a call launches, on both sides of the
boundaries and at every shape chip_smoke.py's phase 11 checks, and where
their plans take K and V whole or in chunks. The kernels themselves run
only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
from __future__ import annotations

import pytest
import torch

import chip_smoke as CS
from mudg_tpu_torch.kernels import short_attention as SA

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,lk,route", [
    (BF, 64, 77, "tma"), (BF, 64, 16, "tma"), (BF, 64, 1, "tma"), (BF, 64, 128, "tma"),
    (BF, 64, 129, "tma"), (BF, 64, 1024, "tma"), (BF, 128, 77, "tma"),
    (BF, 128, 16, "tma"), (F32, 64, 77, "tf32"), (F32, 64, 16, "tf32"),
    (F32, 64, 1, "tf32"), (F32, 64, 128, "tf32"), (F32, 64, 129, "tf32"),
    (F32, 128, 77, "tf32")])
def test_short_kv_route_boundaries(dtype, d, lk, route):
    """`csrc/short_kv.cu` takes every bf16 call and `csrc/short_kv_f32.cu`
    every fp32 one: K and V whole at Lk <= 128 (fp32: at head dim 64), in
    chunks past it (Lk up to 1024, and fp32 at head dim 128)."""
    assert SA.short_kv_route(dtype, d, lk) == route
    chunked = lk > 128 or (dtype == F32 and d == 128)
    assert SA.short_kv_plan(dtype, 2, 256, lk, 2, d).chunked == chunked


@pytest.mark.parametrize("cfg", sorted(CS.SKV_SHAPES))
def test_every_short_kv_site_takes_its_route(cfg):
    """Every bf16 short-KV site of an MDM512 or MDM1024 forward and of the
    training micro-step (Lk 16 and 77, head dim 64) launches the TMA
    kernel with K and V whole; the fp32 forwards' sites the 3xTF32 wgmma
    kernel, whole too; phase 11's "stream" shapes (no MuDG site) the same
    files, in chunks past 128 keys and, in fp32, at head dim 128."""
    dtype = F32 if cfg.endswith("-f32") else BF
    want = "tf32" if dtype == F32 else "tma"
    for qs, ks in CS.SKV_SHAPES[cfg]:
        assert SA.short_kv_attention_eligible(torch.empty(qs, device="meta"),
                                              torch.empty(ks, device="meta"))
        assert SA.short_kv_route(dtype, qs[-1], ks[1]) == want
        plan = SA.short_kv_plan(dtype, qs[0], qs[1], ks[1], qs[2], qs[3])
        assert plan.chunked == (cfg.startswith("stream") and (ks[1] > 128 or (
            dtype == F32 and qs[3] == 128)))
