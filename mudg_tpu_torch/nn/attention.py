"""Attention modules: cross/self attention, feed-forward, spatial and temporal
transformers, and the kernel dispatch.

Port of `mudg_tpu/nn/attention.py`. Module attributes mirror the reference's
torch module paths, so `state_dict()` keys equal the JAX tree paths (a
CrossAttention holds to_q/to_k/to_v, to_out.0 and, with image cross-attention,
to_k_ip/to_v_ip). Tokens are (B, L, C); attention runs with an fp32 softmax.

`impl` is "auto" (the kernels of `mudg_tpu_torch.kernels` at the sites where
the JAX dispatch puts its Pallas kernels) or "plain" (PyTorch ops only).
Relative-position and joint task attention are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F
from ..kernels import flash_attention as FA
from ..kernels import mlp as M
from ..kernels import spatial_attn as SP
from ..kernels import temporal_attn as TA

# Below this sequence length the JAX dispatch keeps attention dense
# (mudg_tpu/nn/attention.py:28-32).
FLASH_MIN_SEQ = 512
# fp32 logits the plain path materialises at once; longer attention loops
# over chunks of the (batch, head) pairs (MDM1024 ds1 would otherwise build
# 160 x 9216^2 fp32 logits, 54 GB).
LOGITS_BUDGET = 2 << 30


def _dense(q, k, v, causal, with_lse):
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = logits.shape[-2:]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return o, (torch.logsumexp(logits, dim=-1) if with_lse else None)


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
    per_pair = lq * k.shape[1] * 4
    pairs = max(1, LOGITS_BUDGET // per_pair)
    if pairs >= b * h:
        o, lse = _dense(q, k, v, causal, with_lse)
        return (o, lse.reshape(b * h, lq)) if with_lse else o
    hc = min(h, pairs)
    bc = max(1, pairs // h) if hc == h else 1
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
    k/v (B, Lk, H, D) -> (B, Lq, H, D). With impl="auto", long equal-length
    non-causal bf16 self-attention (L >= FLASH_MIN_SEQ, L % 64 == 0) goes to
    kernel 5 (`kernels/flash_attention.py`), as the JAX dispatch sends it to
    its Pallas flash kernel; everything else is `plain_attend`. The kernel
    takes head dim 64 only, where the JAX predicate admits any multiple of
    64: no MuDG site has another head dim at L >= 512."""
    if (impl == "auto" and not causal and q.shape[1] >= FLASH_MIN_SEQ
            and FA.eligible(q, k, v)):
        return FA.flash_attention(q, k, v)[0]
    return plain_attend(q, k, v, causal=causal)


def _split_heads(x, heads):
    b, l, _ = x.shape
    return x.reshape(b, l, heads, -1)


def _merge_heads(x):
    b, l, h, d = x.shape
    return x.reshape(b, l, h * d)


class CrossAttention(nn.Module):
    """CrossAttention parameters (attention.py:81-209)."""

    def __init__(self, query_dim, context_dim=None, heads=8, dim_head=64,
                 image_cross=False, alpha_learnable=False):
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


def cross_attention(m, x, context=None, *, heads, image_cross=False, ip_scale=1.0,
                    text_len=77, impl="auto"):
    """CrossAttention forward (attention.py:174-252). x (B, Lq, C); context
    None is self-attention. With `image_cross` the context's tokens past
    `text_len` go through the decoupled image-KV path, added with ip_scale
    (times tanh(alpha) + 1 when alpha is learnable)."""
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
        out = attend(q, _split_heads(F.linear(m.to_k, ctx), heads),
                     _split_heads(F.linear(m.to_v, ctx), heads), impl=impl)
    out = _merge_heads(out)
    if out_ip is not None:
        out_ip = _merge_heads(out_ip)
        if hasattr(m, "alpha"):
            out = out + ip_scale * out_ip * (torch.tanh(m.alpha) + 1.0).to(out.dtype)
        else:
            out = out + ip_scale * out_ip
    return F.linear(m.to_out["0"], out)


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


def feed_forward(ff, x, impl="auto", packed=None):
    """GEGLU FF (attention.py:279-312): the bare FF kernel where eligible."""
    if impl == "auto" and M.eligible(x.shape, x.dtype, ff.net["2"].in_features):
        return M.fused_geglu_ff(x.contiguous(), ff, packed)
    return M.plain_geglu_ff(x, ff)


def feed_forward_block(ff, norm, x, impl="auto", packed=None):
    """LN -> GEGLU FF -> + x (attention.py:326-356). The LN and residual ride
    the kernel only at C < 640, as in the JAX dispatch; wider blocks keep them
    in plain torch around the bare FF kernel."""
    if (impl == "auto" and x.shape[-1] < 640
            and M.eligible(x.shape, x.dtype, ff.net["2"].in_features)):
        return M.fused_geglu_ff_block(x.contiguous(), norm, ff, packed)
    return feed_forward(ff, F.layer_norm(norm, x), impl=impl, packed=packed) + x


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> FF with pre-LN residuals (attention.py:359-438)."""

    def __init__(self, dim, *, heads, dim_head, context_dim=None, image_cross=False,
                 alpha_learnable=False):
        super().__init__()
        self.heads = heads
        self.attn1 = CrossAttention(dim, heads=heads, dim_head=dim_head)
        self.attn2 = CrossAttention(dim, context_dim, heads=heads, dim_head=dim_head,
                                    image_cross=image_cross,
                                    alpha_learnable=alpha_learnable)
        self.ff = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.kernel_packs = {}

    def _self_attn_square(self, attn):
        c = self.norm1.weight.shape[0]
        return (attn.to_q.weight.shape == (c, c) and attn.to_k.weight.shape == (c, c)
                and not attn.image_cross)

    def pack_kernel_weights(self):
        """Kernel-side weights of this block's sites, packed once."""
        c = self.norm1.weight.shape[0]
        packs = {"ff": M.pack_ff(self.ff, self.norm3)}
        if c <= SP.MAX_C and c == self.heads * 64:
            for name, norm, attn in (("attn1", self.norm1, self.attn1),
                                     ("attn2", self.norm2, self.attn2)):
                if self._self_attn_square(attn):
                    packs[name] = SP.pack_stage(norm, attn, self.heads)
        self.kernel_packs = packs

    def forward(self, x, context=None, *, image_cross=False, ip_scale=1.0,
                text_len=77, impl="auto"):
        c = x.shape[-1]
        if (impl == "auto" and self._self_attn_square(self.attn1)
                and SP.eligible(x.shape, x.dtype, c, self.heads)):
            x = SP.fused_self_attention(x.contiguous(), self.norm1, self.attn1, self.heads,
                                        self.kernel_packs.get("attn1"))
        else:
            x = cross_attention(self.attn1, F.layer_norm(self.norm1, x), None,
                                heads=self.heads, impl=impl) + x
        x = cross_attention(self.attn2, F.layer_norm(self.norm2, x), context,
                            heads=self.heads, image_cross=image_cross,
                            ip_scale=ip_scale, text_len=text_len, impl=impl) + x
        return feed_forward_block(self.ff, self.norm3, x, impl=impl,
                                  packed=self.kernel_packs.get("ff"))


def _proj(m, x):
    """proj_in/proj_out: a Linear, or a 1x1 Conv1d (weight (out, in, 1))."""
    w = m.weight.to(x.dtype)
    if w.ndim == 3:
        w = w[..., 0]
    return torch.nn.functional.linear(x, w, None if m.bias is None else m.bias.to(x.dtype))


def _make_proj(d_in, d_out, use_linear):
    return nn.Linear(d_in, d_out) if use_linear else nn.Conv1d(d_in, d_out, 1)


class SpatialTransformer(nn.Module):
    """SpatialTransformer (attention.py:452-471). x (N, H, W, C)."""

    def __init__(self, in_channels, *, heads, dim_head, depth=1, context_dim=None,
                 use_linear=True, image_cross=False, alpha_learnable=False):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm = nn.GroupNorm(32, in_channels)
        self.proj_in = _make_proj(in_channels, inner, use_linear)
        self.transformer_blocks = nn.ModuleDict({
            str(d): BasicTransformerBlock(inner, heads=heads, dim_head=dim_head,
                                          context_dim=context_dim,
                                          image_cross=image_cross,
                                          alpha_learnable=alpha_learnable)
            for d in range(depth)})
        self.proj_out = _make_proj(inner, in_channels, use_linear)

    def forward(self, x, context=None, *, image_cross=False, ip_scale=1.0,
                text_len=77, impl="auto"):
        n, h, w, c = x.shape
        x_in = x
        x = F.group_norm(self.norm, x, eps=1e-6).reshape(n, h * w, c)
        x = _proj(self.proj_in, x)
        for block in self.transformer_blocks.values():
            x = block(x, context, image_cross=image_cross, ip_scale=ip_scale,
                      text_len=text_len, impl=impl)
        x = _proj(self.proj_out, x)
        return x.reshape(n, h, w, c) + x_in


class TemporalTransformer(nn.Module):
    """TemporalTransformer with self-attention only (attention.py:474-571,
    the only_self_att=True path of every MuDG config). x (B, T, H, W, C);
    attention runs over T on (B*H*W, T, C) tokens."""

    def __init__(self, in_channels, *, heads, dim_head, depth=1, use_linear=True):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm = nn.GroupNorm(32, in_channels)
        self.proj_in = _make_proj(in_channels, inner, use_linear)
        self.transformer_blocks = nn.ModuleDict({
            str(d): BasicTransformerBlock(inner, heads=heads, dim_head=dim_head)
            for d in range(depth)})
        self.proj_out = _make_proj(inner, in_channels, use_linear)

    def forward(self, x, *, impl="auto"):
        b, t, h, w, c = x.shape
        x_in = x
        x = F.group_norm(self.norm, x, eps=1e-6)
        x = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        x = _proj(self.proj_in, x)
        for blk in self.transformer_blocks.values():
            packs = blk.kernel_packs
            if impl == "auto" and TA.eligible(x.shape, x.dtype, x.shape[-1], self.heads):
                stages = None
                if "attn1" in packs and "attn2" in packs:
                    stages = (packs["attn1"], packs["attn2"])
                x = TA.fused_double_self_attn(x.contiguous(), (blk.norm1, blk.attn1),
                                              (blk.norm2, blk.attn2), self.heads, stages)
                x = feed_forward_block(blk.ff, blk.norm3, x, impl=impl,
                                       packed=packs.get("ff"))
            else:
                x = blk(x, None, impl=impl)
        x = _proj(self.proj_out, x)
        return x.reshape(b, h, w, t, -1).permute(0, 3, 1, 2, 4) + x_in
