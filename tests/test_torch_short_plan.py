"""Kernel 12's launch plans, on the CPU: `kernels/short_attention.packed_plan`
for the packed kernel (`csrc/short_attn.cu`) and `short_kv_plan` for the
short-KV kernels (`csrc/short_kv.cu`, `csrc/short_kv_f32.cu`).

Each plan is held, at every (T, D, H) and every (D, Lk) the copied
predicates admit, to what the kernels rely on: at most 227 KB of shared
memory a block, TMA box sides of at most 256, at least two stages in
flight. The packed plan's items are held to cover every (batch, head)
sequence once, in whole sequences of 16-row tiles that the kernel's
eight consumer warps take one each (its `pk_row` order mirrored); the
short-KV plans to take K and V whole exactly up to 128 keys (fp32: at head
dim 64), to cover every q tile, and to fit two blocks an SM at every MuDG
site in bf16. No JAX here.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import pytest
import torch

from mudg_tpu_torch.kernels import short_attention as SA

CSRC = Path(SA.__file__).resolve().parent.parent / "csrc"
TS = (1, 2, 4, 8, 16, 32, 64)
SM_SMEM = 233472   # an SM's shared memory (228 KB); each block also takes 1 KB


def _packed_batches(t, h):
    """Batch sizes at which q (B, t, h, D) is eligible: the least, three
    times it (odd factors) and a large one."""
    least = 128 // math.gcd(128, h * t)
    return (least, 3 * least, 5120)


def _pk_row(vr, t, hg):
    """`csrc/short_attn.cu:pk_row`: the box row of an item's row vr in
    sequence order, the box laid out (batch row, position, head)."""
    seq, pos = divmod(vr, t)
    return ((seq // hg) * t + pos) * hg + seq % hg


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", TS)
def test_packed_plan_fits_and_covers(t, d):
    for h in range(1, 41):
        for b in _packed_batches(t, h):
            q = torch.empty(b, t, h, d, device="meta")
            assert SA.packed_short_attention_eligible(q)
            p = SA.packed_plan(b, t, h, d)
            assert p.smem == SA.packed_smem(p.rows, d, p.stages) <= SA.SMEM_MAX, (b, t, h, d)
            assert p.stages >= 2 and max(p.box) <= 256 and p.box == (64, p.hg, t, p.bg)
            assert p.rows == p.bg * t * p.hg and p.rows % 16 == 0 and p.rows <= 128
            assert p.rows * d * 2 <= SA.PACKED_BOX_BYTES
            assert p.items == -(-h // p.hg) * -(-b // p.bg) and 1 <= p.grid <= min(p.items,
                                                                                  SA.SMS)
            # every (batch, head) sequence in one item: head groups and batch groups tile
            heads = [set(range(g * p.hg, min(h, (g + 1) * p.hg))) for g in range(-(-h // p.hg))]
            assert set().union(*heads) == set(range(h)) and sum(map(len, heads)) == h


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", TS)
def test_packed_tiles_take_whole_sequences(t, d):
    """Inside an item, the kernel's 16-row tiles (sequence order, pk_row)
    reach every box row once; a tile holds 16 rows of one sequence (T >=
    16) or 16 / T whole sequences (T < 16), its keys the same sequence's
    rows; the round robin gives each tile of an item to one of the eight
    consumer warps."""
    for h in (1, 2, 5, 8, 10, 20):
        for b in _packed_batches(t, h)[:2]:
            p = SA.packed_plan(b, t, h, d)
            rows = [_pk_row(vr, t, p.hg) for vr in range(p.rows)]
            assert sorted(rows) == list(range(p.rows))
            tiles = p.rows // 16
            assert tiles <= 8
            for j in range(tiles):
                seqs = {vr // t for vr in range(16 * j, 16 * j + 16)}
                key0 = (16 * j // t) * t if t >= 16 else 16 * j
                keys = range(key0, key0 + max(t, 16))
                assert {vr // t for vr in keys} == seqs
                assert len(seqs) == (1 if t >= 16 else 16 // t)
            for i in range(5):   # item i's tiles over warps (i * tiles + j) % 8
                taken = [(w + 8 - (i * tiles) % 8) % 8 for w in range(8)]
                assert sorted(x for x in taken if x < tiles) == list(range(tiles))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_short_kv_plan_fits_at_every_lk(dtype, d):
    for b, lq, h in ((32, 2560, 5), (2, 256, 2), (32, 2304, 10), (1, 38400, 5)):
        for lk in range(1, 1025):
            q, k = torch.empty(b, lq, h, d, device="meta"), torch.empty(b, lk, h, d,
                                                                         device="meta")
            assert SA.short_kv_attention_eligible(q, k)
            p = SA.short_kv_plan(dtype, b, lq, lk, h, d)
            where = (b, lq, lk, h, d, dtype)
            assert p.route == SA.short_kv_route(dtype, d, lk)
            assert p.smem <= SA.SMEM_MAX and p.stages >= 2 and max(p.box) <= 256, where
            tiles = lq // 64
            whole = lk <= 128 and (dtype == torch.bfloat16 or d == 64)
            assert p.chunked == (not whole), where
            if whole:   # K/V whole: Lk rounded up to 16, the span's blocks cover the tiles
                assert p.keys == -(-lk // 16) * 16 >= lk
                if p.route == "tma":
                    assert p.grid == -(-tiles // p.span) * h * b and p.span <= tiles
                else:
                    assert p.span * p.grid >= b * h * tiles
            else:       # chunks of p.keys keys; items cover every q tile
                assert p.keys in (32, 64) and p.grid == min(p.span, SA.SMS)
                per = SA.SK_STREAM_WGS[d] if p.route == "tma" else 2
                assert p.span == b * h * -(-tiles // per)


def test_short_kv_sites_fit_two_blocks_an_sm():
    """bf16 at head dim 64 and Lk <= 80 (every MuDG bf16 site): two blocks
    share an SM, so one's loads overlap the other's products."""
    for lk in range(1, 81):
        p = SA.short_kv_plan(torch.bfloat16, 32, 2560, lk, 5, 64)
        assert not p.chunked and 2 * (p.smem + 1024) <= SM_SMEM, lk


def test_plans_match_the_kernels_constants():
    """The Python tables against the C sources they mirror."""
    kv = (CSRC / "short_kv.cu").read_text()
    wgs = re.search(r"sk_stream_wgs\(int d\) \{ return d == 64 \? (\d) : (\d); \}", kv)
    assert wgs and SA.SK_STREAM_WGS == {64: int(wgs[1]), 128: int(wgs[2])}
    assert f"SK_KEYS = 64;" in kv and "SK_BOX = 64 * 64 * 2;" in kv
    f32 = (CSRC / "short_kv_f32.cu").read_text()
    keys = re.search(r"sc_keys\(int d\) \{ return d == 64 \? (\d+) : (\d+); \}", f32)
    assert keys and [SA.short_kv_plan(torch.float32, 2, 256, 256, 2, d).keys
                     for d in (64, 128)] == [int(keys[1]), int(keys[2])]
    packed = (CSRC / "short_attn.cu").read_text()
    assert "return 1024 + stages * 3 * rows * d * 2 + stages * 16;" in packed
    assert "constexpr int PK_CONSUMERS = 8;" in packed
