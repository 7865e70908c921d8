"""Perceiver-style image-context Resampler (IP-Adapter lineage).

Port of `mudg_tpu/nn/resampler.py` (reference
`lvdm/modules/encoders/resampler.py:48-145`): learned latent queries
(num_queries per frame x video_length, 16 x 16 = 256 tokens) cross-attend to
the CLIP image tokens through `depth` [PerceiverAttention, FF] blocks, then
project 1280 -> 1024 for the UNet's image cross-attention. Module paths equal
the JAX tree's (latents, proj_in, proj_out, norm_out, layers.N.0.*,
layers.N.1.{0, 1, 3}).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from . import functional as F


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """configs/stage1.../config.yaml:101-111."""
    dim: int = 1024
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280
    output_dim: int = 1024
    ff_mult: int = 4
    video_length: int | None = 16

    @property
    def total_queries(self) -> int:
        return self.num_queries * (self.video_length or 1)


class PerceiverAttention(nn.Module):
    """resampler.py:48-93: queries are the latents, keys/values run over
    cat(x, latents); q and k both carry dim_head^-1/4, softmax in fp32."""

    def __init__(self, dim, dim_head, heads):
        super().__init__()
        inner = dim_head * heads
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents, heads, dim_head):
        x = F.layer_norm(self.norm1, x)
        latents = F.layer_norm(self.norm2, latents)
        b, l, _ = latents.shape
        q = F.linear(self.to_q, latents)
        k, v = F.linear(self.to_kv, torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        q, k, v = (z.reshape(b, z.shape[1], heads, dim_head) for z in (q, k, v))
        scale = 1.0 / math.sqrt(math.sqrt(dim_head))
        w = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), (k * scale).float())
        w = torch.softmax(w, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, l, heads * dim_head)
        return F.linear(self.to_out, out)


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig):
        super().__init__()
        self.cfg = cfg
        self.latents = nn.Parameter(torch.zeros(1, cfg.total_queries, cfg.dim))
        self.proj_in = nn.Linear(cfg.embedding_dim, cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.output_dim)
        self.norm_out = nn.LayerNorm(cfg.output_dim)
        self.layers = nn.ModuleDict({
            str(i): nn.ModuleDict({
                "0": PerceiverAttention(cfg.dim, cfg.dim_head, cfg.heads),
                "1": nn.ModuleDict({
                    "0": nn.LayerNorm(cfg.dim),
                    "1": nn.Linear(cfg.dim, cfg.dim * cfg.ff_mult, bias=False),
                    "3": nn.Linear(cfg.dim * cfg.ff_mult, cfg.dim, bias=False)})})
            for i in range(cfg.depth)})

    def forward(self, x):
        """Resampler.forward (resampler.py:134-144): x (B, L_img,
        embedding_dim) -> (B, total_queries, output_dim) in x's dtype."""
        cfg = self.cfg
        lat = self.latents.to(x.dtype).expand(x.shape[0], -1, -1)
        x = F.linear(self.proj_in, x)
        for layer in self.layers.values():
            lat = layer["0"](x, lat, cfg.heads, cfg.dim_head) + lat
            ff = layer["1"]
            h = F.gelu(F.linear(ff["1"], F.layer_norm(ff["0"], lat)))
            lat = F.linear(ff["3"], h) + lat
        return F.layer_norm(self.norm_out, F.linear(self.proj_out, lat))
