"""Stable-Diffusion-2-family 2D conditional UNet (diffusers layout).

Port of `mudg_tpu/models/sd_unet2d.py`: the denoiser behind the
depth-densification stage (reference `data_process/depthlab_tools.py:452-476`).
DepthLab runs it twice: a `reference_unet` (in_channels=4) that encodes the
RGB latent and a `denoising_unet` (in_channels=12) that inpaints the depth
latent while reading the reference UNet's self-attention states
(ReferenceNet).

Module paths are diffusers' `UNet2DConditionModel` state_dict keys
(`down_blocks.0.resnets.0.conv1.weight`,
`...attentions.0.transformer_blocks.0.attn1.to_q.weight`, ...), so a
published state dict loads with `load_state_dict` and JAX's trees through
`convert.load_tree`.

Reference-attention protocol:
  * ``forward(..., ref_mode="write")`` returns ``(out, bank)``, the bank the
    post-norm1 hidden states of every transformer block in traversal order
    (down -> mid -> up);
  * ``forward(..., ref_mode="read", ref_bank=bank)`` pops the entries in the
    same order and concatenates each into its block's self-attention K/V
    (``attn1(q=x, kv=cat([x, ref], seq))``). Both UNets share one
    architecture, so traversal order pairs the blocks as diffusers' sort by
    width does.

Attention and the feed-forward go through `nn/attention.attend` and
`feed_forward_block`, so with impl="auto" the kernels run at the sites where
the JAX dispatch puts its Pallas kernels: kernel 5 at equal-length
self-attention with L >= 512 and L % 64 == 0 (the write pass; the read
pass's keys are twice its queries), kernel 3 at the bf16 FF sites its
predicate admits, and under the switches kernels 11 and 12. impl="plain"
keeps every site on PyTorch ops. Channels-last activations.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from .. import quant as Q
from ..core.schedules import timestep_embedding
from ..kernels import mlp as M
from ..nn import attention as A
from ..nn import functional as F


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    """Shape config of a diffusers UNet2DConditionModel (SD2 defaults).

    DepthLab's denoising_unet has ``in_channels=12``, its reference_unet
    ``in_channels=4``; Marigold depth (the base checkpoint) ``in_channels=8``.
    """

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    head_dim: int = 64
    norm_num_groups: int = 32
    transformer_depth: int = 1

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)

    def heads(self, ch: int) -> int:
        return max(1, ch // self.head_dim)

    def level_has_attn_down(self, i: int) -> bool:
        # CrossAttnDownBlock2D for all but the last level (DownBlock2D)
        return i < self.num_levels - 1

    def level_has_attn_up(self, i: int) -> bool:
        # up_blocks[0] is UpBlock2D (the mirror of the last down block)
        return i > 0


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D: GN/SiLU/conv x2 with a time-embedding shift
    and a 1x1 `conv_shortcut` where the width changes."""

    def __init__(self, c_in, c_out, temb_dim, groups):
        super().__init__()
        self.groups = groups
        self.norm1 = nn.GroupNorm(groups, c_in)
        self.conv1 = nn.Conv2d(c_in, c_out, 3)
        self.time_emb_proj = nn.Linear(temb_dim, c_out)
        self.norm2 = nn.GroupNorm(groups, c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3)
        if c_in != c_out:
            self.conv_shortcut = nn.Conv2d(c_in, c_out, 1)

    def forward(self, x, temb):
        g = self.groups
        h = F.conv2d(self.conv1, F.silu(F.group_norm(self.norm1, x, num_groups=g)))
        emb = F.linear(self.time_emb_proj, F.silu(temb)).to(h.dtype)
        h = h + emb[:, None, None, :]
        h = F.conv2d(self.conv2, F.silu(F.group_norm(self.norm2, h, num_groups=g)))
        if hasattr(self, "conv_shortcut"):
            x = F.conv2d(self.conv_shortcut, x)
        return x + h


class BasicTransformerBlock(nn.Module):
    """diffusers BasicTransformerBlock: self-attn -> cross-attn -> GEGLU FF,
    pre-LN residuals, with the reference-attention hooks."""

    def __init__(self, ch, heads, context_dim):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(ch)
        self.attn1 = A.CrossAttention(ch, heads=heads, dim_head=ch // heads)
        self.norm2 = nn.LayerNorm(ch)
        self.attn2 = A.CrossAttention(ch, context_dim, heads=heads, dim_head=ch // heads)
        self.norm3 = nn.LayerNorm(ch)
        self.ff = A.FeedForward(ch)
        self.kernel_packs = {}

    def pack_kernel_weights(self):
        """Kernel 3's weights of this block's FF, packed once."""
        float_ff = Q.is_float(self.ff.net["0"].proj)
        self.kernel_packs = {"ff": M.pack_ff(self.ff, self.norm3)} if float_ff else {}

    def _attend(self, attn, xn, kv, impl):
        b, l, _ = xn.shape
        h_dim = attn.to_q.weight.shape[0] // self.heads

        def heads(m, z):
            return F.linear(m, z).reshape(z.shape[0], z.shape[1], self.heads, h_dim)

        out = A.attend(heads(attn.to_q, xn), heads(attn.to_k, kv), heads(attn.to_v, kv),
                       impl=impl)
        return F.linear(attn.to_out["0"], out.reshape(b, l, -1))

    def forward(self, x, context, *, ref_mode=None, bank=None, impl="auto"):
        """In "write" mode the post-norm1 state is appended to `bank`; in
        "read" mode the next bank entry joins the self-attention's K/V."""
        xn = F.layer_norm(self.norm1, x)
        if ref_mode == "write":
            bank.append(xn)
            kv = xn
        elif ref_mode == "read":
            kv = torch.cat([xn, bank.pop(0).to(xn.dtype)], dim=1)
        else:
            kv = xn
        x = self._attend(self.attn1, xn, kv, impl) + x
        xn = F.layer_norm(self.norm2, x)
        ctx = xn if context is None else context.to(xn.dtype)
        x = self._attend(self.attn2, xn, ctx, impl) + x
        return A.feed_forward_block(self.ff, self.norm3, x, impl=impl,
                                    packed=self.kernel_packs.get("ff"))


class Transformer2DModel(nn.Module):
    """diffusers Transformer2DModel with use_linear_projection=True (SD2)."""

    def __init__(self, cfg: SDUNetConfig, ch):
        super().__init__()
        self.groups = cfg.norm_num_groups
        self.norm = nn.GroupNorm(cfg.norm_num_groups, ch)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleDict({
            str(d): BasicTransformerBlock(ch, cfg.heads(ch), cfg.cross_attention_dim)
            for d in range(cfg.transformer_depth)})
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context, *, ref_mode=None, bank=None, impl="auto"):
        n, h, w, c = x.shape
        x_in = x
        x = F.group_norm(self.norm, x, num_groups=self.groups, eps=1e-6).reshape(n, h * w, c)
        x = F.linear(self.proj_in, x)
        for blk in self.transformer_blocks.values():
            x = blk(x, context, ref_mode=ref_mode, bank=bank, impl=impl)
        return F.linear(self.proj_out, x).reshape(n, h, w, c) + x_in


class _Sampler(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


class UNet2DConditionModel(nn.Module):
    """UNet2DConditionModel.forward: x (B, H, W, in_channels), t (B,) int
    timesteps, context (B, L, cross_attention_dim) -> (B, H, W,
    out_channels); with ref_mode="write" -> (out, bank)."""

    def __init__(self, cfg: SDUNetConfig = SDUNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        temb = ch0 * 4
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3)
        self.time_embedding = nn.ModuleDict({"linear_1": nn.Linear(ch0, temb),
                                             "linear_2": nn.Linear(temb, temb)})
        self.down_blocks = nn.ModuleDict()
        ch = ch0
        for i, c_out in enumerate(cfg.block_out_channels):
            blk = nn.ModuleDict({"resnets": nn.ModuleDict()})
            if cfg.level_has_attn_down(i):
                blk["attentions"] = nn.ModuleDict()
            for j in range(cfg.layers_per_block):
                blk["resnets"][str(j)] = ResnetBlock2D(ch if j == 0 else c_out, c_out, temb, g)
                if cfg.level_has_attn_down(i):
                    blk["attentions"][str(j)] = Transformer2DModel(cfg, c_out)
            if i < cfg.num_levels - 1:
                blk["downsamplers"] = nn.ModuleDict({"0": _Sampler(c_out)})
            self.down_blocks[str(i)] = blk
            ch = c_out
        c_mid = cfg.block_out_channels[-1]
        self.mid_block = nn.ModuleDict({
            "resnets": nn.ModuleDict({"0": ResnetBlock2D(c_mid, c_mid, temb, g),
                                      "1": ResnetBlock2D(c_mid, c_mid, temb, g)}),
            "attentions": nn.ModuleDict({"0": Transformer2DModel(cfg, c_mid)})})
        self.up_blocks = nn.ModuleDict()
        rev = list(reversed(cfg.block_out_channels))
        for i, c_out in enumerate(rev):
            c_skip_base = rev[min(i + 1, cfg.num_levels - 1)]
            blk = nn.ModuleDict({"resnets": nn.ModuleDict()})
            if cfg.level_has_attn_up(i):
                blk["attentions"] = nn.ModuleDict()
            prev = rev[i - 1] if i > 0 else c_mid
            for j in range(cfg.layers_per_block + 1):
                # the down path pushed layers_per_block states at c_out and
                # one at the next-coarser level's width
                c_skip = c_out if j < cfg.layers_per_block else c_skip_base
                c_in = (prev if j == 0 else c_out) + c_skip
                blk["resnets"][str(j)] = ResnetBlock2D(c_in, c_out, temb, g)
                if cfg.level_has_attn_up(i):
                    blk["attentions"][str(j)] = Transformer2DModel(cfg, c_out)
            if i < cfg.num_levels - 1:
                blk["upsamplers"] = nn.ModuleDict({"0": _Sampler(c_out)})
            self.up_blocks[str(i)] = blk
        self.conv_norm_out = nn.GroupNorm(g, ch0)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3)

    def forward(self, x, t, context, *, ref_mode=None, ref_bank=None, impl="auto"):
        cfg = self.cfg
        g = cfg.norm_num_groups
        bank = [] if ref_mode == "write" else (list(ref_bank) if ref_mode == "read" else [])
        kw = dict(ref_mode=ref_mode, bank=bank, impl=impl)

        temb = timestep_embedding(t, cfg.block_out_channels[0]).to(x.dtype)
        temb = F.linear(self.time_embedding["linear_1"], temb)
        temb = F.linear(self.time_embedding["linear_2"], F.silu(temb))

        h = F.conv2d(self.conv_in, x)
        skips = [h]
        for i in range(cfg.num_levels):
            blk = self.down_blocks[str(i)]
            for j in range(cfg.layers_per_block):
                h = blk["resnets"][str(j)](h, temb)
                if cfg.level_has_attn_down(i):
                    h = blk["attentions"][str(j)](h, context, **kw)
                skips.append(h)
            if i < cfg.num_levels - 1:
                h = F.conv2d(blk["downsamplers"]["0"].conv, h, stride=2,
                             padding=((1, 1), (1, 1)))
                skips.append(h)

        mid = self.mid_block
        h = mid["resnets"]["0"](h, temb)
        h = mid["attentions"]["0"](h, context, **kw)
        h = mid["resnets"]["1"](h, temb)

        for i in range(cfg.num_levels):
            blk = self.up_blocks[str(i)]
            for j in range(cfg.layers_per_block + 1):
                h = blk["resnets"][str(j)](torch.cat([h, skips.pop()], dim=-1), temb)
                if cfg.level_has_attn_up(i):
                    h = blk["attentions"][str(j)](h, context, **kw)
            if i < cfg.num_levels - 1:
                h = F.conv2d(blk["upsamplers"]["0"].conv, F.upsample_nearest_2x(h))

        h = F.silu(F.group_norm(self.conv_norm_out, h, num_groups=g))
        out = F.conv2d(self.conv_out, h)
        if ref_mode == "write":
            return out, bank
        return out
