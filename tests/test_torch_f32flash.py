"""The algebra of the fp32 flash-attention kernels' Hopper design (kernels 5
and 6 in fp32, `csrc/flash_attn_f32.cu`), in plain torch on the CPU, held
against the JAX package.

Every product is three TF32 products, lo_a hi_b + hi_a lo_b + hi_a hi_b in
fp32 (the two small terms first), with x = hi + lo, hi = tf32(x) and lo =
tf32(x - hi), each rounded to nearest with ties away from zero (`cvt.rna`,
emulated on the int32 bits: add 0x1000, clear the low 13 bits). The forward
walks each 128-query block over 64-key tiles with the base-2 online softmax;
P is split after the softmax, and its register A fragment takes each 8-key
group in the order [0, 2, 4, 6, 1, 3, 5, 7] while the kernels' first pass
stores V^T's keys in the same order. The backward walks the dq kernel's
32-key tiles and the dk/dv kernel's 32-query tiles the same way (dS, P^T
and dS^T split in registers; K^T, dO^T and q^T stored in that order).

Held against `mudg_tpu.kernels.flash_attention` in fp32: `_flash_fwd` (the
Pallas forward in interpret mode) for o and lse, `jax.vjp` of
`flash_attention` (its Pallas backward kernels in interpret mode) for the
gradients, at B*H = 2, L = 192 (the last 128-query block holds 64 rows),
on seeded numpy inputs. Tolerances are chip_smoke.py's for the kernels:
o within 1e-5 * max|ref| and lse within 1e-5 (F32_TOL, F32_LSE_TOL), each
gradient within 1e-4 * max|ref| (F32_BWD_TOL). Planted faults must miss
them: one TF32 product in place of three, the hi part truncated and the lo
part dropped, and the key order applied to P's fragments but not to the
stored V^T (a fragment-layout fault).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
import mudg_tpu.kernels.flash_attention as JFA

SHAPE = (2, 192, 1, 64)   # (B, L, H, D): B*H = 2
LOG2E = 1.4426950408889634
PERM8 = [0, 2, 4, 6, 1, 3, 5, 7]
FAULTS = {"1xTF32": dict(mode="1x"), "hi truncated, lo dropped": dict(mode="trunc"),
          "P permuted, V^T not": dict(permute=False)}


def tf32(x):
    """cvt.rna.tf32.f32: x to 10 explicit mantissa bits, to nearest, ties
    away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x, mode="3x"):
    """(hi, lo) with x ~ hi + lo; "1x" drops lo, "trunc" truncates hi and
    drops lo (raw fp32 fed to the tensor core)."""
    if mode == "trunc":
        return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32), None
    hi = tf32(x)
    return hi, (None if mode == "1x" else tf32(x - hi))


def mma3(a, b, mode="3x"):
    """a (M, K) @ b (K, N) as the kernels' products, fp32 sums."""
    ah, al = split(a, mode)
    bh, bl = split(b, mode)
    small = 0.0 if al is None else al @ bh + ah @ bl
    return small + ah @ bh


def perm_positions(n, permute=True):
    """The sequence index that each position of a transposed copy holds,
    over n positions: perm8 order inside each 8-group."""
    idx = torch.arange(n).view(-1, 8)
    return (idx[:, PERM8] if permute else idx).reshape(-1)


def frag(x):
    """An accumulator's columns as its register A fragments take them."""
    return x[:, perm_positions(x.shape[1])]


def fwd_steps(q, k, v, mode="3x", permute=True):
    """The forward kernel's arithmetic on q, k, v (B, L, H, 64) fp32:
    (o (B, L, H, 64), lse (B*H, L))."""
    b, l, h, d = q.shape
    qs = q * np.float32(0.125 * LOG2E)
    o, lse = torch.empty_like(q), torch.empty(b * h, l)
    for bi in range(b):
        for hi in range(h):
            kk, vt = k[bi, :, hi], v[bi, :, hi].T[:, perm_positions(l, permute)]
            for q0 in range(0, l, 128):
                rows = qs[bi, q0:q0 + 128, hi]
                m = torch.full((rows.shape[0], 1), -math.inf)
                s_l = torch.zeros(rows.shape[0], 1)
                acc = torch.zeros(rows.shape[0], d)
                for k0 in range(0, l, 64):
                    s = mma3(rows, kk[k0:k0 + 64].T, mode)
                    mx = torch.maximum(m, s.amax(-1, keepdim=True))
                    alpha = torch.exp2(m - mx)
                    p = torch.exp2(s - mx)
                    s_l = s_l * alpha + p.sum(-1, keepdim=True)
                    m = mx
                    acc = acc * alpha + mma3(frag(p), vt[:, k0:k0 + 64].T, mode)
                o[bi, q0:q0 + 128, hi] = acc / s_l
                lse[bi * h + hi, q0:q0 + 128] = (m * math.log(2.0) + torch.log(s_l))[:, 0]
    return o, lse


def bwd_steps(q, k, v, o, lse, do, mode="3x", permute=True):
    """The dq and dk/dv kernels' arithmetic: (dq, dk, dv), each (B, L, H, 64)."""
    b, l, h, _ = q.shape
    qs = q * np.float32(0.125 * LOG2E)
    delta = (o * do).sum(-1)   # (B, L, H): the first pass's rowsum
    pos = perm_positions(l, permute)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for hi in range(h):
            Q, Qs, K, V, dO = (t[bi, :, hi] for t in (q, qs, k, v, do))
            lse2, dl = lse[bi * h + hi] * np.float32(LOG2E), delta[bi, :, hi]
            kt, qt, dot = K.T[:, pos], Q.T[:, pos], dO.T[:, pos]
            for k0 in range(0, l, 32):   # dq: every query against a 32-key tile
                s = mma3(Qs, K[k0:k0 + 32].T, mode)
                dp = mma3(dO, V[k0:k0 + 32].T, mode)
                ds = torch.exp2(s - lse2[:, None]) * (dp - dl[:, None])
                dq[bi, :, hi] += mma3(frag(ds), kt[:, k0:k0 + 32].T, mode)
            for q0 in range(0, l, 32):   # dk/dv: every key against a 32-query tile
                st = mma3(K, Qs[q0:q0 + 32].T, mode)
                dpt = mma3(V, dO[q0:q0 + 32].T, mode)
                pt = torch.exp2(st - lse2[q0:q0 + 32])
                dst = pt * (dpt - dl[q0:q0 + 32])
                dv[bi, :, hi] += mma3(frag(pt), dot[:, q0:q0 + 32].T, mode)
                dk[bi, :, hi] += mma3(frag(dst), qt[:, q0:q0 + 32].T, mode)
    return dq * 0.125, dk * 0.125, dv


@pytest.fixture(scope="module")
def ref():
    """Seeded inputs and the JAX package's o, lse and gradients."""
    rng = np.random.default_rng(40)
    q, k, v, do = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o, lse = JFA._flash_fwd(*JFA._fold(jq, jk, jv))
    _, vjp = jax.vjp(JFA.flash_attention, jq, jk, jv)
    grads = vjp(jnp.asarray(do))
    b, l, h, d = SHAPE
    o = np.asarray(o).reshape(b, h, l, d).transpose(0, 2, 1, 3)
    return {"inputs": [torch.from_numpy(x) for x in (q, k, v, do)],
            "o": torch.from_numpy(o.copy()), "lse": torch.from_numpy(np.array(lse)[..., 0]),
            "grads": [torch.from_numpy(np.array(g)) for g in grads]}


def fwd_errs(ref, **kw):
    q, k, v, _ = ref["inputs"]
    o, lse = fwd_steps(q, k, v, **kw)
    return ((o - ref["o"]).abs().max().item() / ref["o"].abs().max().item(),
            (lse - ref["lse"]).abs().max().item())


def bwd_errs(ref, **kw):
    q, k, v, do = ref["inputs"]
    o, lse = fwd_steps(q, k, v)
    got = bwd_steps(q, k, v, o, lse, do, **kw)
    return [(g - r).abs().max().item() / r.abs().max().item()
            for g, r in zip(got, ref["grads"])]


def test_fragment_order_is_the_accumulator_layout():
    """perm8 is what the register layouts force: the m64nN fp32 accumulator
    gives thread q of a quad columns 2q, 2q + 1 of each 8-column group, the
    m64k8 tf32 A fragment wants k = q (a0, a1) and q + 4 (a2, a3), and
    `tf32_frag` feeds a0, a1 from column 2q and a2, a3 from 2q + 1: position
    p of the k8 step then holds column PERM8[p]."""
    order = [None] * 8
    for qd in range(4):
        acc_cols = {0: 2 * qd, 1: 2 * qd + 1, 2: 2 * qd, 3: 2 * qd + 1}   # d[4j + i]
        frag_from = {0: 0, 1: 2, 2: 1, 3: 3}                              # a_i <- d[4j + .]
        for i in range(4):
            k = qd + (4 if i >= 2 else 0)
            col = acc_cols[frag_from[i]]
            assert order[k] in (None, col)
            order[k] = col
    assert order == PERM8


def test_tf32_split_keeps_fp32():
    """hi carries 11 significant bits, hi + lo about 22: the split loses
    under 2^-21 of x, one TF32 rounding about 2^-11."""
    x = torch.from_numpy(np.random.default_rng(41).standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi.double() + lo.double() - x.double()).abs() <= 2.0 ** -21 * x.abs()).all()
    assert ((hi.double() - x.double()).abs() <= 2.0 ** -11 * x.abs()).all()


def test_forward_walk_matches_pallas(ref):
    err, lse_err = fwd_errs(ref)
    assert err <= CS.F32_TOL and lse_err <= CS.F32_LSE_TOL, (err, lse_err)


def test_backward_walk_matches_jax_vjp(ref):
    errs = bwd_errs(ref)
    assert max(errs) <= CS.F32_BWD_TOL, errs


@pytest.mark.parametrize("fault", list(FAULTS))
def test_forward_faults_miss(ref, fault):
    err, lse_err = fwd_errs(ref, **FAULTS[fault])
    assert err > CS.F32_TOL or lse_err > CS.F32_LSE_TOL, (fault, err, lse_err)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_backward_faults_miss(ref, fault):
    errs = bwd_errs(ref, **FAULTS[fault])
    assert max(errs) > CS.F32_BWD_TOL, (fault, errs)
