"""Attention modules: cross/self attention, feed-forward, spatial and temporal
transformers, and the kernel dispatch.

Port of `mudg_tpu/nn/attention.py`. Module attributes mirror the reference's
torch module paths, so `state_dict()` keys equal the JAX tree paths (a
CrossAttention holds to_q/to_k/to_v, to_out.0 and, with image cross-attention,
to_k_ip/to_v_ip). Tokens are (B, L, C); attention runs with an fp32 softmax.

`impl` is "auto" (the kernels of `mudg_tpu_torch.kernels` at the sites where
the JAX dispatch puts its Pallas kernels), "train" (the JAX training
dispatch, attention.py:34-47: only the kernels with a backward kernel, each as
an autograd op; kernel 1 is off, kernel 5 takes attention at L >= 512, the
temporal and FF kernels take the sites their JAX backward predicates admit)
or "plain" (PyTorch ops only). The JAX package's kernel opt-out switches are
read where it reads them, default "1": MUDG_FUSED_SPATIAL, MUDG_STREAM_SPATIAL
and MUDG_FLASHBLOCK (kernel 1's sites, by the tier JAX puts them on),
MUDG_FUSED_FF (kernel 3) and MUDG_FUSED_TEMPORAL (kernel 2); "0" sends their
sites down the JAX fallback chain (MUDG_FUSED_TCONV is read in `unet3d.py`).
The options that no MuDG config sets run on the plain path wherever JAX
keeps them off its kernels (attention.py:372-375, :527-540):
relative-position attention (additive terms on the logits and the values)
and the causal mask keep a temporal block off kernel 2 (and any block off
kernel 1); joint task attention (Lk = num_tasks * L) meets no kernel at
MuDG's shapes; the cross-context temporal blocks (only_self_att=False) run
their self-attention over T = 16 rows, which kernel 1 does not take, and
their FFs on kernel 3. A
transformer block's three residual outputs are the tag sites blk_attn1,
blk_attn2 and blk_ff of the remat policies (attention.py:419-438, :559-560).
A layer that `quant.quantize_module` made int8 keeps its site off the fused
kernels 1-3, as the JAX predicates' `"weight" in p` tests send int8 layers
to the XLA path (attention.py:291,335,376,535); kernel 5 takes activations
only and still applies.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from . import functional as F
from . import remat as R
from .. import quant as Q
from ..kernels import flash_attention as FA
from ..kernels import mlp as M
from ..kernels import short_attention as SA
from ..kernels import spatial_attn as SP
from ..kernels import temporal_attn as TA
from ..parallel import sp as SP_
from ..utils import profiling

# Below this sequence length the JAX dispatch keeps attention dense
# (mudg_tpu/nn/attention.py:28-32).
FLASH_MIN_SEQ = 512
# fp32 logits the plain path materialises at once; longer attention loops
# over chunks of the (batch, head) pairs (MDM1024 ds1 would otherwise build
# 160 x 9216^2 fp32 logits, 54 GB).
LOGITS_BUDGET = 2 << 30


def dense_logits(q, k, causal=False):
    """fp32 logits (B, H, Lq, Lk) of q (B, Lq, H, D) against k (B, Lk, H, D),
    scaled by D^-0.5; the causal mask keeps key j <= query i + Lk - Lq."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = logits.shape[-2:]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    return logits


def _dense(q, k, v, causal, with_lse):
    logits = dense_logits(q, k, causal)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return o, (torch.logsumexp(logits, dim=-1) if with_lse else None)


def pair_chunks(b, h, per_pair):
    """(batch chunk, head chunk) whose (batch, head) pairs hold at most
    LOGITS_BUDGET bytes at `per_pair` bytes each; (b, h) when all fit."""
    pairs = max(1, LOGITS_BUDGET // per_pair)
    if pairs >= b * h:
        return b, h
    hc = min(h, pairs)
    return (max(1, pairs // h) if hc == h else 1), hc


def plain_attend(q, k, v, *, causal=False, with_lse=False):
    """Scaled dot-product attention in plain torch, q (B, Lq, H, D), k/v
    (B, Lk, H, D) -> (B, Lq, H, D), and with `with_lse` the natural-log
    logsumexp of each row's logits, (B*H, Lq) fp32. Logits and softmax in
    fp32, probabilities cast to v's dtype for the P @ V product
    (attention.py:115-128); the causal mask keeps key j <= query i + Lk - Lq.
    Each (batch, head) pair is computed on its own, so splitting the pairs
    into chunks of at most LOGITS_BUDGET bytes of logits gives the same
    result as one pass."""
    b, lq, h, _ = q.shape
    bc, hc = pair_chunks(b, h, lq * k.shape[1] * 4)
    if (bc, hc) == (b, h):
        o, lse = _dense(q, k, v, causal, with_lse)
        return (o, lse.reshape(b * h, lq)) if with_lse else o
    rows = []
    for b0 in range(0, b, bc):
        parts = [_dense(q[b0:b0 + bc, :, h0:h0 + hc], k[b0:b0 + bc, :, h0:h0 + hc],
                        v[b0:b0 + bc, :, h0:h0 + hc], causal, with_lse)
                 for h0 in range(0, h, hc)]
        rows.append((torch.cat([p[0] for p in parts], dim=2),
                     torch.cat([p[1] for p in parts], dim=1) if with_lse else None))
    o = torch.cat([r[0] for r in rows])
    if not with_lse:
        return o
    return o, torch.cat([r[1] for r in rows]).reshape(b * h, lq)


def attend(q, k, v, *, causal=False, impl="auto"):
    """Scaled dot-product attention (attention.py:63-128), q (B, Lq, H, D),
    k/v (B, Lk, H, D) -> (B, Lq, H, D). With impl="auto" or "train", long
    equal-length non-causal self-attention (L >= FLASH_MIN_SEQ, L % 64 ==
    0), bf16 or fp32, goes to kernel 5 (`kernels/flash_attention.py`; under
    "train" with kernel 6 as its backward), as the JAX dispatch sends it to
    its Pallas flash kernel in any dtype; everything else is `plain_attend`.
    The kernel takes head dim 64 only, where the JAX predicate admits any
    multiple of 64: no MuDG site has another head dim at L >= 512. Next, under
    `MUDG_SHORT_ATTN=1`, a CUDA q and k that `short_kv_attention_eligible`
    admits go to kernel 12's short-KV attention (attention.py:100-113; under
    "train" as its autograd op), bf16 or fp32 as the Pallas kernel takes
    either."""
    if (impl in ("auto", "train") and not causal and q.shape[1] >= FLASH_MIN_SEQ
            and FA.eligible(q, k, v)):
        if impl == "train":
            return FA.flash_attention_train(q, k, v)
        return FA.flash_attention(q, k, v)[0]
    if (impl in ("auto", "train") and not causal and os.environ.get("MUDG_SHORT_ATTN") == "1"
            and F.on_card(q) and SA.short_kv_attention_eligible(q, k)):
        if impl == "train":
            return SA.short_kv_attention_op(q, k, v)
        return SA.short_kv_attention(q, k, v)
    return plain_attend(q, k, v, causal=causal)


def _split_heads(x, heads):
    b, l, c = x.shape
    return x.reshape(b, l, heads, c // heads)


def _merge_heads(x):
    b, l, h, d = x.shape
    return x.reshape(b, l, h * d)


class RelativePosition(nn.Module):
    """A clipped relative-position embedding table (attention.py:20-39),
    (2 * max_rel + 1, dim_head)."""

    def __init__(self, max_rel, dim_head):
        super().__init__()
        self.embeddings_table = nn.Parameter(torch.zeros(2 * max_rel + 1, dim_head))


def relative_position_bias(table, length_q, length_k, max_rel):
    """The table's rows at the clipped offsets k - q, (length_q, length_k,
    d) (attention.py:163-171)."""
    rq = torch.arange(length_q, device=table.device)[:, None]
    rk = torch.arange(length_k, device=table.device)[None, :]
    return table[(rk - rq).clamp(-max_rel, max_rel) + max_rel]


class CrossAttention(nn.Module):
    """CrossAttention parameters (attention.py:81-209); with
    `relative_position`, the key and value tables relative_position_k/v
    over `temporal_length` (attention.py:597-606)."""

    def __init__(self, query_dim, context_dim=None, heads=8, dim_head=64,
                 image_cross=False, alpha_learnable=False, relative_position=False,
                 temporal_length=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleDict({"0": nn.Linear(inner, query_dim)})
        self.image_cross = image_cross
        if image_cross:
            self.to_k_ip = nn.Linear(context_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(context_dim, inner, bias=False)
            if alpha_learnable:
                self.alpha = nn.Parameter(torch.zeros(()))
        if relative_position:
            if temporal_length is None:
                raise ValueError("relative-position attention needs temporal_length")
            self.relative_position_k = RelativePosition(temporal_length, dim_head)
            self.relative_position_v = RelativePosition(temporal_length, dim_head)


def _relative_attention(m, q, k, v, max_rel, causal):
    """Attention with additive relative-position terms on the logits and
    the values and an optional causal mask (attention.py:220-245): fp32
    logits and softmax, probabilities in v's dtype."""
    scale = q.shape[-1] ** -0.5
    lq, lk = q.shape[1], k.shape[1]
    k2 = relative_position_bias(m.relative_position_k.embeddings_table, lq, lk, max_rel)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits + torch.einsum("bqhd,qkd->bhqk", q.float(), k2.float())
    logits = logits * scale
    if causal:
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    v2 = relative_position_bias(m.relative_position_v.embeddings_table, lq, lq, max_rel)
    return out + torch.einsum("bhqk,qkd->bqhd", probs, v2.to(probs.dtype))


def cross_attention(m, x, context=None, *, heads, image_cross=False, ip_scale=1.0,
                    text_len=77, causal=False, temporal_length=None, impl="auto"):
    """CrossAttention forward (attention.py:174-252). x (B, Lq, C); context
    None is self-attention. With `image_cross` the context's tokens past
    `text_len` go through the decoupled image-KV path, added with ip_scale
    (times tanh(alpha) + 1 when alpha is learnable). A module with
    relative-position tables takes the relative branch (over
    `temporal_length`, with the causal mask when `causal`); `causal`
    otherwise masks the plain attention."""
    self_attn = context is None
    ctx = x if self_attn else context
    out_ip = None
    if image_cross and not self_attn and ctx.shape[1] <= text_len:
        image_cross = False
    q = _split_heads(F.linear(m.to_q, x), heads)
    if image_cross and not self_attn:
        ctx, ctx_img = ctx[:, :text_len], ctx[:, text_len:]
        k = _split_heads(F.linear(m.to_k, ctx), heads)
        v = _split_heads(F.linear(m.to_v, ctx), heads)
        out = attend(q, k, v, impl=impl)
        out_ip = attend(q, _split_heads(F.linear(m.to_k_ip, ctx_img), heads),
                        _split_heads(F.linear(m.to_v_ip, ctx_img), heads), impl=impl)
    else:
        if not self_attn:
            ctx = ctx[:, :text_len]
        k = _split_heads(F.linear(m.to_k, ctx), heads)
        v = _split_heads(F.linear(m.to_v, ctx), heads)
        if hasattr(m, "relative_position_k"):
            out = _relative_attention(m, q, k, v, temporal_length, causal)
        else:
            out = attend(q, k, v, causal=causal, impl=impl)
    out = _merge_heads(out)
    if out_ip is not None:
        out_ip = _merge_heads(out_ip)
        if hasattr(m, "alpha"):
            out = out + ip_scale * out_ip * (torch.tanh(m.alpha) + 1.0).to(out.dtype)
        else:
            out = out + ip_scale * out_ip
    return F.linear(m.to_out["0"], out)


def joint_cross_attention(m, x, *, heads, num_tasks, impl="auto"):
    """JointCrossAttention (attention.py:255-276): x (B, L, C) with B =
    num_tasks * per-task batch in task-major chunks; each sample attends to
    the keys and values of every task's sample at its index within the
    chunk, concatenated (Lk = num_tasks * L)."""
    b, l, _ = x.shape
    if b % num_tasks:
        raise ValueError(f"batch {b} not divisible by num_tasks {num_tasks}")
    per = b // num_tasks

    def shared(t):   # (M*per, L, C) -> (per, M*L, C), tiled over the tasks
        c = t.shape[-1]
        t = t.reshape(num_tasks, per, l, c).transpose(0, 1).reshape(per, num_tasks * l, c)
        return _split_heads(t.repeat(num_tasks, 1, 1), heads)

    q = _split_heads(F.linear(m.to_q, x), heads)
    out = attend(q, shared(F.linear(m.to_k, x)), shared(F.linear(m.to_v, x)), impl=impl)
    return F.linear(m.to_out["0"], _merge_heads(out))


class GEGLUProj(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward parameters (attention.py:579-606): net.0.proj
    (dim -> 2*inner, [value | gate]) and net.2 (inner -> dim)."""

    def __init__(self, dim, mult=4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleDict({"0": GEGLUProj(dim, inner), "2": nn.Linear(inner, dim)})


def _ff_kernel_site(ff, x, impl):
    """The JAX FF dispatch (attention.py:289-303, :333-350): the kernel's
    own predicate, and under "train" the backward kernel's as well;
    MUDG_FUSED_FF=0 keeps the plain FF."""
    inner = ff.net["2"].in_features
    if (impl not in ("auto", "train") or not Q.is_float(ff.net["0"].proj)
            or os.environ.get("MUDG_FUSED_FF", "1") != "1"
            or not M.eligible(x.shape, x.dtype, inner)):
        return False
    c = x.shape[-1]
    return impl == "auto" or M.ff_bwd_eligible(x.numel() // c, c, inner)


def feed_forward(ff, x, impl="auto", packed=None):
    """GEGLU FF (attention.py:279-312): the bare FF kernel where eligible."""
    if _ff_kernel_site(ff, x, impl):
        if impl == "train":
            return M.geglu_ff_train(x, ff)
        return M.fused_geglu_ff(x.contiguous(), ff, packed)
    # the (M, 2 * inner) product is tagged ff_inner, which the remat
    # policies recompute (attention.py:307-309); `M.plain_geglu_ff`'s ops
    u, g = F.linear(ff.net["0"].proj, x, tag="ff_inner").chunk(2, dim=-1)
    return F.linear(ff.net["2"], u * F.gelu(g))


def feed_forward_block(ff, norm, x, impl="auto", packed=None):
    """LN -> GEGLU FF -> + x (attention.py:326-356), the transformer block's
    blk_ff. The LN and residual ride the kernel only at C < 640, as in the
    JAX dispatch; wider blocks keep them in plain torch around the bare FF
    kernel."""
    if x.shape[-1] < 640 and _ff_kernel_site(ff, x, impl):
        R.tag("blk_ff")
        if impl == "train":
            return M.geglu_ff_block_train(x, norm, ff)
        return M.fused_geglu_ff_block(x.contiguous(), norm, ff, packed)
    y = feed_forward(ff, F.layer_norm(norm, x), impl=impl, packed=packed)
    with R.site("blk_ff"):
        return y + x


class BasicTransformerBlock(nn.Module):
    """self-attn -> (joint task attn) -> cross-attn -> FF with pre-LN
    residuals (attention.py:359-438). `temporal`: a block of a
    TemporalTransformer, whose two self-attentions kernel 2 takes (packed in
    its head order) instead of kernel 1. `relative_position` gives both
    attentions relative-position tables over `temporal_length`;
    `domain_cross` adds the joint task attention attn_joint and its
    norm_joint (attention.py:642)."""

    def __init__(self, dim, *, heads, dim_head, context_dim=None, image_cross=False,
                 alpha_learnable=False, temporal=False, relative_position=False,
                 temporal_length=None, domain_cross=False):
        super().__init__()
        self.heads = heads
        self.temporal = temporal
        rel = dict(relative_position=relative_position, temporal_length=temporal_length)
        self.attn1 = CrossAttention(dim, heads=heads, dim_head=dim_head, **rel)
        self.attn2 = CrossAttention(dim, context_dim, heads=heads, dim_head=dim_head,
                                    image_cross=image_cross,
                                    alpha_learnable=alpha_learnable, **rel)
        self.ff = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        if domain_cross:
            self.attn_joint = CrossAttention(dim, heads=heads, dim_head=dim_head)
            self.norm_joint = nn.LayerNorm(dim)
        self.kernel_packs = {}

    def _self_attn_square(self, attn):
        c = self.norm1.weight.shape[0]
        return (all(Q.is_float(m) for m in (attn.to_q, attn.to_k, attn.to_v, attn.to_out["0"]))
                and attn.to_q.weight.shape == (c, c) and attn.to_k.weight.shape == (c, c)
                and not attn.image_cross and not hasattr(attn, "relative_position_k"))

    def pack_kernel_weights(self):
        """Kernel-side weights of this block's float sites, packed once."""
        c = self.norm1.weight.shape[0]
        packs = {}
        if Q.is_float(self.ff.net["0"].proj):
            packs["ff"] = M.pack_ff(self.ff, self.norm3)
        pack_stage = TA.pack_stage if self.temporal else SP.pack_stage
        if c <= SP.MAX_C and c == self.heads * 64:
            for name, norm, attn in (("attn1", self.norm1, self.attn1),
                                     ("attn2", self.norm2, self.attn2)):
                if self._self_attn_square(attn):
                    packs[name] = pack_stage(norm, attn, self.heads)
        self.kernel_packs = packs

    def _spatial_kernel_site(self, x, impl, causal=False):
        """The JAX spatial dispatch (attention.py:371-405): kernel 1 wherever
        the CUDA kernel takes the shape (it serves JAX's three tiers), but
        never causal or with relative-position tables. MUDG_FUSED_SPATIAL=0
        sends every site, and MUDG_STREAM_SPATIAL=0 / MUDG_FLASHBLOCK=0 the
        sites JAX puts on their tier (`SP.tier` names it from copies of the
        JAX predicates), to `cross_attention` (kernel 5 at L >= 512), as in
        JAX."""
        c = x.shape[-1]
        return (impl == "auto" and not causal and self._self_attn_square(self.attn1)
                and os.environ.get("MUDG_FUSED_SPATIAL", "1") == "1"
                and SP.eligible(x.shape, x.dtype, c, self.heads)
                and not SP.switched_off(x.shape, x.dtype, c, self.heads))

    def forward(self, x, context=None, *, image_cross=False, ip_scale=1.0,
                text_len=77, causal=False, temporal_length=None, num_tasks=1, impl="auto"):
        if self._spatial_kernel_site(x, impl, causal):
            R.tag("blk_attn1")
            x = SP.fused_self_attention(x.contiguous(), self.norm1, self.attn1, self.heads,
                                        self.kernel_packs.get("attn1"))
        else:
            a = cross_attention(self.attn1, F.layer_norm(self.norm1, x), None,
                                heads=self.heads, causal=causal,
                                temporal_length=temporal_length, impl=impl)
            with R.site("blk_attn1"):
                x = a + x
        if hasattr(self, "attn_joint"):
            x = joint_cross_attention(self.attn_joint, F.layer_norm(self.norm_joint, x),
                                      heads=self.heads, num_tasks=num_tasks, impl=impl) + x
        a = cross_attention(self.attn2, F.layer_norm(self.norm2, x), context,
                            heads=self.heads, image_cross=image_cross,
                            ip_scale=ip_scale, text_len=text_len,
                            temporal_length=temporal_length, impl=impl)
        with R.site("blk_attn2"):
            x = a + x
        return feed_forward_block(self.ff, self.norm3, x, impl=impl,
                                  packed=self.kernel_packs.get("ff"))


def _proj(m, x):
    """proj_in/proj_out: a Linear, or a 1x1 Conv1d (weight (out, in, 1)),
    run as a linear in its mm_out site (attention.py:440-449)."""
    return F.linear(m, x)


def _make_proj(d_in, d_out, use_linear):
    return nn.Linear(d_in, d_out) if use_linear else nn.Conv1d(d_in, d_out, 1)


class SpatialTransformer(nn.Module):
    """SpatialTransformer (attention.py:452-471). x (N, H, W, C)."""

    def __init__(self, in_channels, *, heads, dim_head, depth=1, context_dim=None,
                 use_linear=True, image_cross=False, alpha_learnable=False,
                 domain_cross=False):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm = nn.GroupNorm(32, in_channels)
        self.proj_in = _make_proj(in_channels, inner, use_linear)
        self.transformer_blocks = nn.ModuleDict({
            str(d): BasicTransformerBlock(inner, heads=heads, dim_head=dim_head,
                                          context_dim=context_dim,
                                          image_cross=image_cross,
                                          alpha_learnable=alpha_learnable,
                                          domain_cross=domain_cross)
            for d in range(depth)})
        self.proj_out = _make_proj(inner, in_channels, use_linear)

    def forward(self, x, context=None, *, image_cross=False, ip_scale=1.0,
                text_len=77, num_tasks=1, impl="auto"):
        with profiling.span("unet.spatial"):
            n, h, w, c = x.shape
            x_in = x
            x = F.group_norm(self.norm, x, eps=1e-6).reshape(n, h * w, c)
            x = _proj(self.proj_in, x)
            for block in self.transformer_blocks.values():
                x = block(x, context, image_cross=image_cross, ip_scale=ip_scale,
                          text_len=text_len, num_tasks=num_tasks, impl=impl)
            x = _proj(self.proj_out, x)
            return x.reshape(n, h, w, c) + x_in


class TemporalTransformer(nn.Module):
    """TemporalTransformer (attention.py:474-571). x (B, T, H, W, C);
    attention runs over T on (B*H*W, T, C) tokens. Kernel 2 takes both
    self-attentions of a block where eligible and neither causal nor
    relative-position; under impl="train" only where the JAX backward
    predicate `bwd_eligible` holds too (attention.py:546-551), with kernel 9
    as its backward. `context_dim` sizes the blocks' attn2 keys and values
    for the cross-context path (only_self_att=False), which a call with a
    context takes (attention.py:487-508)."""

    def __init__(self, in_channels, *, heads, dim_head, depth=1, use_linear=True,
                 relative_position=False, temporal_length=None, context_dim=None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm = nn.GroupNorm(32, in_channels)
        self.proj_in = _make_proj(in_channels, inner, use_linear)
        self.transformer_blocks = nn.ModuleDict({
            str(d): BasicTransformerBlock(inner, heads=heads, dim_head=dim_head, temporal=True,
                                          context_dim=context_dim,
                                          relative_position=relative_position,
                                          temporal_length=temporal_length)
            for d in range(depth)})
        self.proj_out = _make_proj(inner, in_channels, use_linear)

    def forward(self, x, context=None, *, causal=False, temporal_length=None, impl="auto",
                sp=None):
        """context: None (self-attention only), or per-frame rows (B*T, L, D)
        for the cross-context path: frame j's rows repeated (h*w)//t times
        so that token row i attends to frame i // ((h*w)//t), as the
        reference's repeat does (a ValueError where t does not divide h*w),
        its blocks run without the causal mask or relative terms. sp: a
        sequence-parallel sharding whose ranks each hold a block of W; the
        norm's statistics are then summed over them."""
        with profiling.span("unet.temporal"):
            b, t, h, w, c = x.shape
            x_in = x
            x = F.group_norm(self.norm, x, eps=1e-6, **SP_.kw(sp))
            x = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
            x = _proj(self.proj_in, x)
            n, t, c = x.shape
            if context is not None:
                hw = h * w
                if hw % t:
                    raise ValueError(f"cross temporal transformer requires (h*w) % t == 0 "
                                     f"(reference repeat semantics), got {hw} % {t}")
                l, dc = context.shape[-2:]
                ctx = context.reshape(b, t, l, dc).repeat_interleave(hw // t, dim=1)
                ctx = ctx.reshape(b * hw, l, dc)
                for blk in self.transformer_blocks.values():
                    x = blk(x, ctx, impl=impl)
            else:
                site = (impl in ("auto", "train") and not causal
                        and os.environ.get("MUDG_FUSED_TEMPORAL", "1") == "1"
                        and TA.eligible(x.shape, x.dtype, c, self.heads)
                        and (impl == "auto" or TA.bwd_eligible(n * t, c)))
                for blk in self.transformer_blocks.values():
                    if not (site and Q.is_float(blk.attn1.to_q) and Q.is_float(blk.attn2.to_q)
                            and not hasattr(blk.attn1, "relative_position_k")):
                        x = blk(x, None, causal=causal, temporal_length=temporal_length, impl=impl)
                        continue
                    packs = blk.kernel_packs
                    stages = (blk.norm1, blk.attn1), (blk.norm2, blk.attn2)
                    R.tag("blk_attn2")   # kernel 2's output
                    if impl == "train":
                        x = TA.double_self_attn_train(x.contiguous(), *stages, self.heads)
                    else:
                        packed = None
                        if "attn1" in packs and "attn2" in packs:
                            packed = (packs["attn1"], packs["attn2"])
                        x = TA.fused_double_self_attn(x.contiguous(), *stages, self.heads, packed)
                    x = feed_forward_block(blk.ff, blk.norm3, x, impl=impl, packed=packs.get("ff"))
            x = _proj(self.proj_out, x)
            return x.reshape(b, h, w, t, -1).permute(0, 3, 1, 2, 4) + x_in
