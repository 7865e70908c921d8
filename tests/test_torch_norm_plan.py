"""Kernel 11's GroupNorm launch planner and its per-call host path, on the CPU.

`kernels/norms.gn_plan` picks, per GroupNorm shape, one thread-block cluster
per sample (each CTA a slab of rows in shared memory) or the two passes.
Here it is held, at every shape of chip_smoke.py's GN_SHAPES and at
GN_LARGEST (kernel 4's clips, the largest samples the fit predicate
admits), to the rules the kernels rely on: every row covered exactly once
(the kernels' loops mirrored), at most 16 CTAs a cluster, at most 227 KB of
shared memory a block, and the two passes taken exactly where no cluster
holds a sample. The card's cudaOccupancyMaxActiveClusters is stood in for
by a model of the H100 (clusters inside one GPC of 16 SMs, 8 GPCs), and by
the card's own answers as chip_smoke.py phase 11 recorded them
(torch_h100_gn_clusters.json), with which the plans are pinned to those
the card took. The LayerNorm's plan is made by its C launcher alone;
tests/test_torch_cuda.py holds it on the card.

Then the wrappers' path where no gradient is wanted: the autograd ops call
the wrappers alone (no `autograd.Function`), with the same values as the
ops with a gradient and the same wrapper calls, so the same launch counts,
on the CPU and on the meta device. No JAX here.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import chip_smoke as CS
from mudg_tpu_torch.kernels import norms as N
from mudg_tpu_torch.nn import functional as TF

H100_SMS = 132
GPC_SMS, GPCS = 16, 8
SM_SMEM = 233472    # an SM's shared memory (228 KB); each block also takes 1 KB


def h100_clusters(cs, c, smem, itemsize, silu):
    """Clusters of `cs` CTAs the model card holds at once: blocks per SM by
    shared memory and by registers (a GN block of up to 256 threads takes
    half an SM's, a wider one all), a cluster's CTAs inside one GPC."""
    per_sm = min(SM_SMEM // (smem + 1024), 2 if N.gn_threads(c) <= 256 else 1)
    return GPCS * (GPC_SMS * per_sm // cs)


def _gn_cases():
    cases = []
    for cfg, shapes in CS.GN_SHAPES.items():
        itemsize = 4 if cfg.endswith("-f32") else 2
        for shape in shapes:
            cases.append((shape[0], math.prod(shape[1:-1]), shape[-1], itemsize, False))
    return cases + list(CS.GN_LARGEST)


def _holds_a_cluster(rows, c, itemsize, groups=32):
    return c // groups >= 8 and any(
        N.gn_cluster_smem(-(-rows // cs), c, itemsize, groups) <= N.SMEM_MAX
        for cs in range(1, N.GN_MAX_CLUSTER + 1))


@pytest.mark.parametrize("n,rows,c,itemsize,silu", _gn_cases())
def test_gn_plan_covers_each_row_once_within_the_card(n, rows, c, itemsize, silu):
    plan = N.gn_plan(n, rows, c, itemsize, 32, silu, active=h100_clusters)
    assert (plan.cluster > 0) == _holds_a_cluster(rows, c, itemsize)
    seen = np.zeros(rows, dtype=np.int64)
    if plan.cluster:
        assert 1 <= plan.cluster <= N.GN_MAX_CLUSTER and plan.chunks == plan.cluster
        assert 1 <= plan.keep <= plan.per
        assert plan.smem == N.gn_cluster_smem(plan.keep, c, itemsize, 32) <= N.SMEM_MAX
        assert h100_clusters(plan.cluster, c, plan.smem, itemsize, silu) >= 1
        for rank in range(plan.cluster):   # gn_cluster_kernel's slab, its pieces, the rest
            r0 = min(rows, rank * plan.per)
            nr = min(rows, r0 + plan.per) - r0
            assert nr > 0, "an empty CTA"
            nk = min(nr, plan.keep)
            rpp = -(-nk // N.GN_PIECES)
            for p in range(N.GN_PIECES):
                lo, hi = p * rpp, min(nk, p * rpp + rpp)
                if hi <= lo:
                    break
                seen[r0 + lo:r0 + hi] += 1
            seen[r0 + nk:r0 + nr] += 1   # read from device memory
    else:
        assert plan.keep == 0
        assert plan.smem == 0 and 1 <= plan.chunks <= N.GN_MAX_CHUNKS
        assert (plan.chunks - 1) * plan.per < rows <= plan.chunks * plan.per
        for chunk in range(plan.chunks):
            seen[chunk * plan.per:min(rows, (chunk + 1) * plan.per)] += 1
    assert (seen == 1).all()


def test_gn_plan_takes_the_two_passes_exactly_for_kernel_4_and_large_fp32():
    two_pass = {case for case in _gn_cases()
                if not N.gn_plan(*case[:4], 32, case[4], active=h100_clusters).cluster}
    assert two_pass == {(2, 16 * 40 * 64, 320, 2, True), (2, 16 * 72 * 128, 320, 2, True),
                        (2, 32 * 32, 1024, 4, False)}


def test_gn_plan_prefers_fewer_waves_and_falls_back_without_room():
    # two samples of 1.6 MB: 16 CTAs each rather than 8 (twice the CTAs moving
    # the same bytes in one wave)
    assert N.gn_plan(2, 640, 1280, 2, active=h100_clusters).cluster == 16
    # a card that holds no cluster, or C / G below a chunk's channels: two passes
    assert N.gn_plan(32, 640, 1280, 2, active=lambda *a: 0).cluster == 0
    assert N.gn_plan(2, 64, 64, 2, active=h100_clusters).cluster == 0


# the card's answers ([cluster, c, smem, itemsize, silu, clusters at once])
# to every question gn_plan asks at _gn_cases, from chip_smoke.py phase 11's
# report (its "kernel11_plans"; NVIDIA H100 80GB HBM3)
H100_ANSWERS = {tuple(a[:5]): a[5] for a in json.loads(
    (Path(__file__).with_name("torch_h100_gn_clusters.json")).read_text())}

# the plans the card took at GN_SHAPES, (cluster, rows per CTA, rows held)
# or (0, rows per chunk, 0) for the two passes, as the same phase 11 run
# printed them, and at GN_LARGEST (n, rows, C, itemsize, silu) ->
H100_PLANS = {
    (2, 640, 1280, 2, False): (16, 40, 40),
    (32, 160, 1280, 2, False): (3, 54, 54),
    (32, 160, 1920, 2, False): (3, 54, 54),
    (32, 160, 2560, 2, False): (4, 40, 40),
    (32, 160, 640, 2, False): (3, 54, 54),
    (32, 640, 1280, 2, False): (7, 92, 43),
    (32, 640, 1920, 2, False): (7, 92, 28),
    (32, 640, 320, 2, False): (3, 214, 214),
    (32, 640, 640, 2, False): (7, 92, 86),
    (32, 640, 960, 2, False): (7, 92, 57),
    (32, 2560, 320, 2, False): (7, 366, 173),
    (32, 40, 1280, 2, False): (3, 14, 14),
    (32, 40, 2560, 2, False): (3, 14, 14),
    (32, 576, 1280, 2, False): (7, 83, 43),
    (32, 576, 1920, 2, False): (7, 83, 28),
    (32, 576, 2560, 2, False): (14, 42, 42),
    (32, 576, 640, 2, False): (7, 83, 83),
    (32, 2304, 320, 2, False): (7, 330, 173),
    (32, 2304, 640, 2, False): (7, 330, 86),
    (32, 144, 1280, 2, False): (3, 48, 48),
    (32, 144, 2560, 2, False): (4, 36, 36),
    (16, 2560, 512, 2, False): (12, 214, 107),
    (1, 640, 1280, 2, False): (16, 40, 40),
    (16, 160, 1280, 2, False): (6, 27, 27),
    (16, 160, 1920, 2, False): (6, 27, 27),
    (16, 160, 2560, 2, False): (6, 27, 27),
    (16, 160, 640, 2, False): (6, 27, 27),
    (16, 640, 1280, 2, False): (12, 54, 43),
    (16, 640, 1920, 2, False): (12, 54, 28),
    (16, 640, 320, 2, False): (6, 107, 107),
    (16, 640, 640, 2, False): (6, 107, 107),
    (16, 640, 960, 2, False): (6, 107, 107),
    (16, 2560, 320, 2, False): (12, 214, 173),
    (16, 40, 1280, 2, False): (6, 7, 7),
    (16, 40, 2560, 2, False): (6, 7, 7),
    (2, 640, 1280, 4, False): (16, 40, 40),
    (32, 160, 1280, 4, False): (7, 23, 21),
    (32, 160, 1920, 4, False): (7, 23, 14),
    (32, 160, 2560, 4, False): (8, 20, 20),
    (32, 160, 640, 4, False): (3, 54, 54),
    (32, 640, 1280, 4, False): (7, 92, 21),
    (32, 640, 320, 4, False): (7, 92, 86),
    (32, 640, 640, 4, False): (7, 92, 43),
    (32, 640, 960, 4, False): (7, 92, 28),
    (32, 2560, 320, 4, False): (7, 366, 86),
    (32, 40, 1280, 4, False): (3, 14, 14),
    (32, 40, 2560, 4, False): (3, 14, 14),
    (32, 576, 1280, 4, False): (7, 83, 21),
    (32, 576, 640, 4, False): (7, 83, 43),
    (32, 2304, 320, 4, False): (7, 330, 86),
    (32, 144, 1280, 4, False): (7, 21, 21),
    (32, 144, 2560, 4, False): (7, 21, 21),
    (2, 40960, 320, 2, True): (0, 320, 0),
    (2, 147456, 320, 2, True): (0, 1152, 0),
    (2, 1024, 1024, 4, False): (0, 8, 0),
    (2, 1536, 1024, 2, False): (16, 96, 96),
    (1, 600, 1280, 2, False): (16, 38, 38),
    (1, 600, 2560, 2, False): (16, 38, 38),
    (1, 2400, 640, 2, False): (16, 150, 150),
    (1, 600, 1280, 4, False): (16, 38, 38),
}


def h100_answers(cs, c, smem, itemsize, silu):
    return H100_ANSWERS[(cs, c, smem, itemsize, bool(silu))]


@pytest.mark.parametrize("n,rows,c,itemsize,silu", _gn_cases())
def test_gn_plan_is_the_one_the_card_took(n, rows, c, itemsize, silu):
    plan = N.gn_plan(n, rows, c, itemsize, 32, silu, active=h100_answers)
    assert (plan.cluster, plan.per, plan.keep) == H100_PLANS[(n, rows, c, itemsize, silu)]


def test_gn_chunks_fill_the_card_within_the_cap():
    # kernel 4's two clips: the cap binds; 32 samples: the target does
    assert N.gn_chunks(2, 16 * 40 * 64, 320)[0] == N.GN_MAX_CHUNKS
    chunks, per = N.gn_chunks(32, 16 * 40 * 64, 320)
    assert chunks == -(-N.GN_TARGET_BLOCKS // 32) and (chunks - 1) * per < 16 * 40 * 64


class _Norm(nn.Module):
    def __init__(self, c, dtype):
        super().__init__()
        gen = torch.Generator().manual_seed(c)
        self.weight = nn.Parameter((1 + 0.1 * torch.randn(c, generator=gen)).to(dtype))
        self.bias = nn.Parameter((0.1 * torch.randn(c, generator=gen)).to(dtype))


@pytest.fixture
def calls(monkeypatch):
    """Counts the wrapper calls of kernel 11 and fails any autograd.Function
    use where no gradient is wanted; the dispatch takes the kernel path."""
    monkeypatch.setenv("MUDG_FUSED_NORMS", "1")
    monkeypatch.setattr(TF, "on_card", lambda x: True)
    counts = {"group_norm": 0, "layer_norm": 0}
    for name, key in (("fused_group_norm", "group_norm"), ("fused_layer_norm", "layer_norm")):
        orig = getattr(N, name)

        def wrapped(*a, _orig=orig, _key=key, **k):
            counts[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(N, name, wrapped)
    return counts


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_no_grad_path_matches_the_autograd_ops(calls, monkeypatch, device, dtype):
    gen = torch.Generator().manual_seed(3)
    xg = torch.randn(2, 3, 4, 5, 64, generator=gen).to(dtype)
    xl = torch.randn(2, 16, 64, generator=gen).to(dtype)
    gn, ln = _Norm(64, dtype).to(device), _Norm(64, dtype).to(device)
    xg, xl = xg.to(device), xl.to(device)
    with torch.enable_grad():
        want_g = TF.group_norm(gn, xg)
        want_l = TF.layer_norm(ln, xl)
    assert want_g.grad_fn is not None and want_l.grad_fn is not None   # the ops
    assert calls == {"group_norm": 1, "layer_norm": 1}

    def refuse(*a, **k):
        raise AssertionError("autograd.Function used where no gradient is wanted")
    monkeypatch.setattr(N._GroupNorm, "apply", refuse)
    monkeypatch.setattr(N._LayerNorm, "apply", refuse)
    with torch.no_grad():
        got_g = TF.group_norm(gn, xg)
        got_l = TF.layer_norm(ln, xl)
    for p in (*gn.parameters(), *ln.parameters()):   # no input needs a gradient
        p.requires_grad_(False)
    with torch.enable_grad():
        also_g = TF.group_norm(gn, xg)
        also_l = TF.layer_norm(ln, xl)
    assert calls == {"group_norm": 3, "layer_norm": 3}
    for got, want in ((got_g, want_g), (got_l, want_l), (also_g, want_g), (also_l, want_l)):
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        assert got.grad_fn is None
        if device == "cpu":
            assert torch.equal(got, want.detach())
