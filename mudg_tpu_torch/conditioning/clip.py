"""OpenCLIP ViT-H-14 text and vision towers (frozen conditioning encoders).

Port of `mudg_tpu/conditioning/clip.py` (reference
`lvdm/modules/encoders/condition.py`):
  * TextTower: FrozenOpenCLIPEmbedder (:174-234), causal transformer stopped
    at the penultimate block, then ln_final -> (B, 77, 1024);
  * VisionTower: FrozenOpenCLIPImageEmbedderV2 (:295-372), the ViT-H visual
    tower returning every token after the transformer, no ln_post and no
    projection -> (B, 257, 1280); `preprocess_image` is the bicubic 224
    resize of [-1, 1] input and the CLIP mean/std normalisation.

Module attributes follow the open_clip state_dict paths of the JAX trees
(token_embedding, positional_embedding, class_embedding, conv1,
transformer.resblocks.N.{ln_1, attn.{in_proj_weight, in_proj_bias,
out_proj}, ln_2, mlp.{c_fc, c_proj}}, ln_pre, ln_final), so a tree loads
strictly through `convert.load_tree`. Attention stays plain, as the JAX
towers run it (impl="xla").
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from ..nn import functional as F
from ..nn.attention import attend

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """open_clip ViT-H-14 text tower."""
    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    context_length: int = 77
    skip_last_layers: int = 1  # 'penultimate' (condition.py:199-200)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """open_clip ViT-H-14 visual tower."""
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    heads: int = 16
    layers: int = 32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens(self) -> int:
        return self.grid * self.grid + 1


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters: the fused in_proj (3W, W)
    and its bias, and out_proj."""

    def __init__(self, width):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, heads, causal=False):
        b, l, w = x.shape
        qkv = torch.nn.functional.linear(x, self.in_proj_weight.to(x.dtype),
                                         self.in_proj_bias.to(x.dtype))
        q, k, v = (z.reshape(b, l, heads, w // heads) for z in qkv.chunk(3, dim=-1))
        out = attend(q, k, v, causal=causal, impl="plain")
        return F.linear(self.out_proj, out.reshape(b, l, w))


class ResidualAttentionBlock(nn.Module):
    """open_clip ResidualAttentionBlock: pre-LN attention + MLP
    (c_fc -> exact GELU -> c_proj)."""

    def __init__(self, width):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadAttention(width)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, 4 * width),
                                  "c_proj": nn.Linear(4 * width, width)})

    def forward(self, x, heads, causal=False):
        x = x + self.attn(F.layer_norm(self.ln_1, x), heads, causal=causal)
        h = F.linear(self.mlp["c_fc"], F.layer_norm(self.ln_2, x))
        return x + F.linear(self.mlp["c_proj"], F.gelu(h))


def _transformer(width, layers):
    return nn.ModuleDict({"resblocks": nn.ModuleDict(
        {str(i): ResidualAttentionBlock(width) for i in range(layers)})})


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.width))
        self.transformer = _transformer(cfg.width, cfg.layers)
        self.ln_final = nn.LayerNorm(cfg.width)

    def forward(self, tokens):
        """encode_with_transformer (condition.py:214-231): tokens (B, 77)
        integer -> (B, 77, width) in the tower's dtype; runs layers -
        skip_last_layers causal blocks, then ln_final."""
        cfg = self.cfg
        x = self.token_embedding.weight[tokens]
        x = x + self.positional_embedding.to(x.dtype)
        blocks = self.transformer["resblocks"]
        for i in range(cfg.layers - cfg.skip_last_layers):
            x = blocks[str(i)](x, cfg.heads, causal=True)
        return F.layer_norm(self.ln_final, x)


def _keys_cubic(x):
    """Keys cubic kernel, a = -0.5, of |offset| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) bicubic resampling matrix of jax.image.resize
    (scale_and_translate with antialias: the kernel is widened by in/out
    when downsampling, each output's weights are renormalised to sum 1, and
    outputs whose sample point falls outside the input get 0)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_bicubic(x, size: int):
    """(B, H, W, C) -> (B, size, size, C), as jax.image.resize(..., "bicubic")
    in x's dtype: two separable products with the matrices of
    `resize_weights`; an axis already of `size` is left as it is."""
    h, w = x.shape[1:3]
    if h != size:
        wh = torch.as_tensor(resize_weights(h, size), dtype=x.dtype, device=x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    if w != size:
        ww = torch.as_tensor(resize_weights(w, size), dtype=x.dtype, device=x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    return x


def preprocess_image(x):
    """condition.py:322-330: [-1, 1] (B, H, W, 3) -> bicubic 224 resize,
    CLIP-normalised."""
    x = (resize_bicubic(x, 224) + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.tokens, cfg.width))
        self.ln_pre = nn.LayerNorm(cfg.width)
        self.transformer = _transformer(cfg.width, cfg.layers)

    def forward(self, images):
        """encode_with_vision_transformer (condition.py:342-372): images
        (B, H, W, 3) in [-1, 1] -> `preprocess_image` -> every token after
        the transformer, (B, tokens, width), in the images' dtype."""
        cfg = self.cfg
        images = preprocess_image(images)
        b = images.shape[0]
        x = F.conv2d(self.conv1, images, stride=cfg.patch_size, padding=((0, 0), (0, 0)))
        x = x.reshape(b, cfg.grid * cfg.grid, cfg.width)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = F.layer_norm(self.ln_pre, x)
        for blk in self.transformer["resblocks"].values():
            x = blk(x, cfg.heads)
        return x
