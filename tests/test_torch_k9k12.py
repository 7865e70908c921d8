"""The algebra of kernel 12's fp32 short-KV design and kernel 9's Hopper
design, in plain torch on the CPU, held against the JAX package.

Kernel 12 in fp32 (`csrc/short_kv_f32.cu`): K and V of a (batch, head) pair
are padded with zeros from Lk to NK (Lk rounded up to 16: 77 to 80) and
split once into tf32 hi and lo copies, V transposed with each 8-key group
in the order [0, 2, 4, 6, 1, 3, 5, 7]; each 64-row q tile is split in
registers; S = Q K^T is three TF32 products (lo hi + hi lo, then hi hi),
scaled by d^-0.5 log2(e) after the product, the padded keys masked to -inf,
the base-2 softmax normalised, P split as its register fragments take it
(each 8-key group in that order), and O = P V three TF32 products per
64-key chunk, each chunk in an accumulator of its own added in fp32.
`_short_kv_f32_steps` walks that; it is held against the Pallas
`_short_kv_kernel` in interpret mode within 1e-5 * max|ref| (chip_smoke's
F32_TOL), and two planted faults must miss: "1xTF32" (one TF32 product in
place of three) and the key order on P's fragments but not on V^T.

The chunked routes (`csrc/short_kv.cu`'s streamed kernel in bf16, past
128 keys; `csrc/short_kv_f32.cu`'s chunked kernel in fp32, past 128 keys
and at head dim 128): `_short_kv_chunk_steps` walks the key chunks with
the online softmax (running max and sum, O rescaled per chunk; in bf16 P
rounded before it is normalised, in fp32 each chunk's P V a 3xTF32
product of its own) and is held against the Pallas kernel at D 64 / Lk
1024 and D 128 / Lk 256 in bf16, D 64 / Lk 1024 and D 128 / Lk 77 in fp32;
O not rescaled (and, in fp32, "1xTF32") must miss, and the bf16 one-pass
rounding stays within the bf16 tolerance of the reference's order.

Kernel 9 (`csrc/temporal_attn_bwd.cu`), per stage: xn = LN(x) in bf16 with
fp32 row statistics; dO = dy Wo rounded to bf16; per 64-row tile and head,
the q'|k|v product over the head's 192 rows of the head-ordered packing
[Wq'_h | Wk_h | Wv_h] (`temporal_attn.pack_stage_params`) rounded to bf16,
and per 16-row sequence P, o = P_bf16 v, dP = dO v^T, dS = P (dP -
rowsum(P dP)) ln 2 in bf16, dq' = dS k, dk = dS^T q', dv = P_bf16^T dO, each
rounded to bf16 into dqkv in head order; dWqkv' = dqkv^T xn and dWo = dy^T o
in fp32 from the materialised xn and o; dLN(x) = dqkv Wqkv' in fp32; the LN
backward in fp32. `_temporal_bwd_steps` walks those steps and restores the
[q | k | v] order; it is held against the Pallas `_bwd_one_stage` in
interpret mode at C = 320 and 512 (128 rows, eight sequences) within 5e-2 *
max|ref| for dx and each gradient (chip_smoke's BWD_TOL), and the walk
without the softmax Jacobian's row-sum term must miss.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import chip_smoke as CS
import mudg_tpu.kernels.short_attention as JSA
import mudg_tpu.kernels.temporal_attn as JTA
from mudg_tpu.nn import attention as JA
from mudg_tpu_torch.kernels import temporal_attn as TA
from mudg_tpu_torch.nn import attention as TAT
from test_torch_f32flash import frag, mma3, perm_positions
from test_torch_util import port, random_tree, t, to_jax

LOG2E = 1.4426950408889634
LN2 = math.log(2.0)

# ------------------------------------------------------------------ kernel 12

SKV = (1, 256, 2, 64)   # q (B, Lq, H, D); Lk = 77 pads to NK = 80


def _short_kv_f32_steps(q, k, v, mode="3x", permute=True):
    """Kernel 12's fp32 arithmetic on q (B, Lq, H, 64) over k, v (B, Lk, H,
    64), fp32: o (B, Lq, H, 64)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    nk = -(-lk // 16) * 16
    pad = (0, 0, 0, 0, 0, nk - lk)
    kp, vp = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    o = torch.empty_like(q)
    mask = torch.arange(nk) >= lk
    for bi in range(b):
        for hi in range(h):
            kk = kp[bi, :, hi]                                      # (NK, 64), K-major
            vt = vp[bi, :, hi].T[:, perm_positions(nk, permute)]    # V^T, keys in perm8
            for q0 in range(0, lq, 64):
                s = mma3(q[bi, q0:q0 + 64, hi], kk.T, mode) * np.float32(d ** -0.5 * LOG2E)
                s = s.masked_fill(mask, -math.inf)
                p = torch.exp2(s - s.amax(-1, keepdim=True))
                p = p / p.sum(-1, keepdim=True)
                acc = 0.0
                for c0 in range(0, nk, 64):   # each 64-key chunk on its own
                    acc = acc + mma3(frag(p[:, c0:c0 + 64]), vt[:, c0:c0 + 64].T, mode)
                o[bi, q0:q0 + 64, hi] = acc
    return o


@pytest.fixture(scope="module")
def skv_ref():
    """Seeded fp32 q, k, v and the Pallas short-KV kernel's o (interpret
    mode, K/V padded to 128 lanes and masked there)."""
    rng = np.random.default_rng(90)
    b, lq, h, d = SKV
    q = rng.standard_normal(SKV).astype(np.float32)
    k, v = (rng.standard_normal((b, 77, h, d)).astype(np.float32) for _ in range(2))
    o = JSA._short_kv_apply(*map(jnp.asarray, (q, k, v)))
    return [torch.from_numpy(x) for x in (q, k, v)], torch.from_numpy(np.array(o))


def _skv_err(skv_ref, **kw):
    (q, k, v), ref = skv_ref
    got = _short_kv_f32_steps(q, k, v, **kw)
    return (got - ref).abs().max().item() / ref.abs().max().item()


def test_short_kv_f32_walk_matches_pallas(skv_ref):
    assert _skv_err(skv_ref) <= CS.F32_TOL


@pytest.mark.parametrize("fault", [dict(mode="1x"), dict(permute=False)],
                         ids=["1xTF32", "P permuted, V^T not"])
def test_short_kv_f32_walk_sees_planted_faults(skv_ref, fault):
    assert _skv_err(skv_ref, **fault) > CS.F32_TOL


def test_short_kv_f32_padding_masks_the_zero_keys(skv_ref):
    """The keys from 77 to 80 are zero rows of K: their logits are 0, not
    -inf, so without the mask they take softmax weight and the walk misses."""
    (q, k, v), ref = skv_ref
    pad = (0, 0, 0, 0, 0, 3)
    got = _short_kv_f32_steps(q, torch.nn.functional.pad(k, pad),
                              torch.nn.functional.pad(v, pad))
    assert (got - ref).abs().max().item() > CS.F32_TOL * ref.abs().max().item()


def _short_kv_chunk_steps(q, k, v, chunk, mode="3x", rescale=True):
    """The chunked kernels' arithmetic (`csrc/short_kv.cu`'s streamed one in
    bf16, `csrc/short_kv_f32.cu`'s chunked one in fp32) on q (B, Lq, H, D)
    over k, v (B, Lk, H, D): K and V in `chunk`-key chunks, the keys past Lk
    zero and masked; per chunk S (bf16 operands, fp32 sums; in fp32 three
    TF32 products), scaled after the product, the running max m and sum l
    in fp32 and O rescaled by 2^(m_old - m_new) (not, with rescale=False);
    in bf16 P = 2^(s - m) rounded to bf16 before it is normalised and P V
    summed into O in fp32; in fp32 P split as its fragments take it and
    each chunk's P V a product of its own added to O. o = O / l, in q's
    dtype."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    f32 = q.dtype == torch.float32
    nk = -(-lk // chunk) * chunk
    pad = (0, 0, 0, 0, 0, nk - lk)
    kp, vp = (torch.nn.functional.pad(x, pad).float() for x in (k, v))
    scale = np.float32(d ** -0.5 * LOG2E)
    o = torch.empty(b, lq, h, d)
    for bi in range(b):
        for hi in range(h):
            qq = q[bi, :, hi].float()
            m = torch.full((lq, 1), -math.inf)
            l = torch.zeros(lq, 1)
            acc = torch.zeros(lq, d)
            for c0 in range(0, nk, chunk):
                kc, vc = kp[bi, c0:c0 + chunk, hi], vp[bi, c0:c0 + chunk, hi]
                s = (mma3(qq, kc.T, mode) if f32 else qq @ kc.T) * scale
                s = s.masked_fill(torch.arange(c0, c0 + chunk) >= lk, -math.inf)
                mx = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2(m - mx) if rescale else torch.ones_like(mx)
                p = torch.exp2(s - mx)
                l = l * alpha + p.sum(-1, keepdim=True)
                if f32:
                    vt = vc.T[:, perm_positions(chunk)]
                    pv = mma3(frag(p), vt.T, mode)
                else:
                    pv = p.to(torch.bfloat16).float() @ vc
                acc = acc * alpha + pv
                m = mx
            o[bi, :, hi] = acc / l
    return o.to(q.dtype)


def _normalised_first(q, k, v):
    """The reference's order in bf16 (short_attention.py:174-180): P
    normalised, then rounded to bf16 for P V."""
    s = torch.einsum("qd,kd->qk", q.float(), k.float()) * np.float32(q.shape[-1] ** -0.5)
    p = torch.softmax(s, -1)
    return (p.to(torch.bfloat16).float() @ v.float()).to(torch.bfloat16)


@pytest.fixture(scope="module", params=[(64, 1024, "bf16"), (128, 256, "bf16"),
                                        (64, 1024, "f32"), (128, 77, "f32")],
                ids=lambda p: f"d{p[0]}-lk{p[1]}-{p[2]}")
def chunk_ref(request):
    """Seeded q (1, 256, 2, D), k, v (1, Lk, 2, D) and the Pallas short-KV
    kernel's o on them (interpret mode), at shapes of the chunked route."""
    d, lk, dt = request.param
    rng = np.random.default_rng(91)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, 256, 2, d), (1, lk, 2, d), (1, lk, 2, d))]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dt == "bf16" else (jnp.float32, torch.float32)
    o = JSA._short_kv_apply(*(jnp.asarray(a).astype(jdt) for a in arrs))
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    return ts, torch.from_numpy(np.array(o.astype(jnp.float32))), dt


def _chunk_err(chunk_ref, **kw):
    (q, k, v), ref, dt = chunk_ref
    chunk = 32 if dt == "f32" and q.shape[-1] == 128 else 64
    got = _short_kv_chunk_steps(q, k, v, chunk, **kw).float()
    tol = CS.F32_TOL if dt == "f32" else CS.TOL
    return (got - ref).abs().max().item() / ref.abs().max().item() / tol


def test_short_kv_chunk_walk_matches_pallas(chunk_ref):
    """The chunked walks within chip_smoke's tolerance of the Pallas kernel
    (bf16 3e-2, fp32 1e-5 of max|ref|)."""
    assert _chunk_err(chunk_ref) <= 1.0


@pytest.mark.parametrize("fault", [dict(rescale=False), dict(mode="1x")],
                         ids=["O not rescaled", "1xTF32"])
def test_short_kv_chunk_walk_sees_planted_faults(chunk_ref, fault):
    if fault.get("mode") == "1x" and chunk_ref[2] != "f32":
        fault = dict(rescale=False)   # bf16 products are one product already
    assert _chunk_err(chunk_ref, **fault) > 1.0


@pytest.mark.parametrize("d,lk", [(64, 1024), (128, 256)])
def test_short_kv_bf16_one_pass_rounding_is_within_tolerance(d, lk):
    """The streamed bf16 kernel rounds P to bf16 before normalising it; the
    reference normalises first. On the same inputs the two orders part by
    less than the bf16 tolerance (the known difference, ROADMAP.md)."""
    rng = np.random.default_rng(92)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((1, 256, 2, d), (1, lk, 2, d), (1, lk, 2, d)))
    one_pass = _short_kv_chunk_steps(q, k, v, 64).float()
    first = torch.stack([_normalised_first(q[0, :, hi], k[0, :, hi], v[0, :, hi])
                         for hi in range(q.shape[2])], 1)[None].float()
    diff = (one_pass - first).abs().max().item()
    assert 0.0 < diff <= CS.TOL * first.abs().max().item()


# ------------------------------------------------------------------- kernel 9

def _bf(a):
    return a.to(torch.bfloat16).float()


def _stage(c, seed):
    """A stage's JAX parameter dict and the port's (norm, attention) modules
    with the same seeded weights, heads of 64."""
    heads = c // 64
    attn = random_tree(jax.eval_shape(lambda: JA.init_cross_attention(
        jax.random.PRNGKey(0), c, heads=heads, dim_head=64)), seed)
    f32 = jax.ShapeDtypeStruct((c,), jnp.float32)
    norm = random_tree({"weight": f32, "bias": f32}, seed + 1)
    mods = (port(nn.LayerNorm(c), norm), port(TAT.CrossAttention(c, heads=heads, dim_head=64),
                                              attn))
    return {"norm": to_jax(norm), **to_jax(attn)}, mods


def _grads_torch_layout(g):
    """The JAX per-stage gradient dict in `stage_params` order, torch layouts."""
    out = g["to_out"]["0"]
    return (g["norm"]["weight"], g["norm"]["bias"], g["to_q"]["weight"].T,
            g["to_k"]["weight"].T, g["to_v"]["weight"].T, out["weight"].T, out["bias"])


def _temporal_bwd_steps(x, dy, params, heads, drop_rowsum=False):
    """Kernel 9's staging of one stage on x, dy (rows, C) bf16 values in fp32
    and the stage's fp32 parameters: (dx, (dLN w, dLN b, dWq, dWk, dWv, dWo,
    dbo)) in torch layouts."""
    rows, c = x.shape
    d = c // heads
    pk = TA.pack_stage_params(*params, heads)
    wqkv, wo = pk.wqkv.float(), pk.wo.float()   # bf16 values; wqkv in head order
    mu = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    xhat = (x - mu) * rstd
    xn = _bf(xhat * pk.ln_w + pk.ln_b)
    dout = _bf(dy @ wo)
    o, dqkv = torch.empty(rows, c), torch.empty(rows, 3 * c)
    for m0 in range(0, rows, 64):
        for h in range(heads):
            acc = xn[m0:m0 + 64] @ wqkv[192 * h:192 * h + 192].T
            for s0 in range(0, 64, 16):   # each warp's 16-row sequence
                q2, k, v = (_bf(acc[s0:s0 + 16, 64 * j:64 * j + 64]) for j in range(3))
                do = dout[m0 + s0:m0 + s0 + 16, 64 * h:64 * h + 64]
                s = q2 @ k.T
                p = torch.exp2(s - s.amax(-1, keepdim=True))
                p = p / p.sum(-1, keepdim=True)
                pb = _bf(p)
                dp = do @ v.T
                ds = p * dp if drop_rowsum else p * (dp - (p * dp).sum(-1, keepdim=True))
                ds = _bf(ds * LN2)
                rr = slice(m0 + s0, m0 + s0 + 16)
                o[rr, 64 * h:64 * h + 64] = _bf(pb @ v)
                dqkv[rr, 192 * h:192 * h + 192] = _bf(torch.cat([ds @ k, ds.T @ q2, pb.T @ do], 1))
    dwqkv = TA.qkv_order_rows(dqkv.T @ xn, heads)
    dwo = dy.T @ o
    dxn = dqkv @ wqkv
    dxh = dxn * pk.ln_w
    dx = dy + rstd * (dxh - dxh.mean(-1, keepdim=True)
                      - xhat * (dxh * xhat).mean(-1, keepdim=True))
    fold = d ** -0.5 * LOG2E
    return _bf(dx), ((dxn * xhat).sum(0), dxn.sum(0), dwqkv[:c] * fold, dwqkv[c:2 * c],
                     dwqkv[2 * c:], dwo, dy.sum(0))


@pytest.fixture(scope="module", params=[320, 512], ids=["C320", "C512"])
def k9_ref(request):
    """One stage's bf16 tokens and upstream gradient (eight sequences), its
    fp32 parameters, and the Pallas `_bwd_one_stage`'s dx and gradients."""
    c = request.param
    heads = c // 64
    p, mods = _stage(c, 70 + c)
    rng = np.random.default_rng(71 + c)
    x, dy = (rng.standard_normal((128, c)).astype(np.float32) for _ in range(2))
    xb, dyb = (jnp.asarray(a, jnp.bfloat16) for a in (x, dy))
    dx, g = JTA._bwd_one_stage(xb, dyb, p, c, heads, 16)
    as_t = lambda a: t(np.asarray(a.astype(jnp.float32)))   # noqa: E731
    return (as_t(xb), as_t(dyb), TA.stage_params(*mods), heads,
            [as_t(dx), *(t(np.asarray(a)) for a in _grads_torch_layout(g))])


def _k9_errs(k9_ref, **kw):
    x, dy, params, heads, ref = k9_ref
    dx, grads = _temporal_bwd_steps(x, dy, [w.detach() for w in params], heads, **kw)
    return [(a - r).abs().max().item() / r.abs().max().item()
            for a, r in zip((dx, *grads), ref)]


def test_temporal_bwd_walk_matches_pallas(k9_ref):
    errs = _k9_errs(k9_ref)
    assert max(errs) <= CS.BWD_TOL, errs


def test_temporal_bwd_walk_sees_the_rowsum_fault(k9_ref):
    assert max(_k9_errs(k9_ref, drop_rowsum=True)) > CS.BWD_TOL
