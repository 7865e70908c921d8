"""SegFormer (MiT encoder + all-MLP decode head), the semantic stage model.

Port of `mudg_tpu/models/segformer.py` (reference
`data_process/pipeline_segment.py:19-122`, SegFormer-B3 cityscapes, 19
classes). The modules mirror HuggingFace's
`SegformerForSemanticSegmentation`, so `state_dict()` keys are HF's
(`segformer.encoder.block.0.0.attention.self.query.weight`,
`decode_head.linear_fuse.weight`, ...) and a published state dict loads with
`load_hf_state_dict`; JAX's `init_segformer` trees ({'encoder', 'decode_head'})
load through the same function after `convert.pytree_to_state_dict`.

Inference only: dropout and drop-path are identity, batch norm uses the
running statistics. Activations are channels-last; attention is the plain
fp32-softmax path (`nn/attention.attend`, impl="plain", as JAX runs it with
impl="xla"), so no attention kernel runs here; under `MUDG_FUSED_NORMS=1`
the LayerNorms go to kernel 11 where the JAX predicate admits them.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from ..nn import attention as A
from ..nn import functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class SegFormerConfig:
    """Defaults = SegFormer-B3 cityscapes (nvidia/segformer-b3-finetuned-
    cityscapes-1024-1024)."""
    hidden_sizes: Sequence[int] = (64, 128, 320, 512)
    depths: Sequence[int] = (3, 4, 18, 3)
    num_attention_heads: Sequence[int] = (1, 2, 5, 8)
    sr_ratios: Sequence[int] = (8, 4, 2, 1)
    patch_sizes: Sequence[int] = (7, 3, 3, 3)
    strides: Sequence[int] = (4, 2, 2, 2)
    mlp_ratio: int = 4
    decoder_hidden_size: int = 768
    num_labels: int = 19
    layer_norm_eps: float = 1e-6

    @classmethod
    def b0(cls, **kw):
        return cls(hidden_sizes=(32, 64, 160, 256), depths=(2, 2, 2, 2),
                   decoder_hidden_size=256, **kw)


def resize_bilinear(x, hw):
    """(N, H, W, C) -> (N, h, w, C), torch's bilinear with align_corners=False
    and no antialiasing. It equals `jax.image.resize(..., "bilinear")` when
    upsampling, which is the only way SegFormer resizes."""
    y = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                                        mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


class _Linear(nn.Module):
    """A module holding one Linear as `proj` (HF's SegformerMLP)."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out)


class SelfAttention(nn.Module):
    """SegformerEfficientSelfAttention: keys and values from the input
    reduced by a stride-sr conv and a LayerNorm where sr > 1."""

    def __init__(self, c, sr_ratio):
        super().__init__()
        self.query, self.key, self.value = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(c, c, sr_ratio, stride=sr_ratio)
            self.layer_norm = nn.LayerNorm(c)


class Attention(nn.Module):
    def __init__(self, c, sr_ratio):
        super().__init__()
        self.self = SelfAttention(c, sr_ratio)
        self.output = nn.ModuleDict({"dense": nn.Linear(c, c)})


class DWConv(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.dwconv = nn.Conv2d(c, c, 3, padding=1, groups=c)


class MixFFN(nn.Module):
    def __init__(self, c, hidden):
        super().__init__()
        self.dense1 = nn.Linear(c, hidden)
        self.dwconv = DWConv(hidden)
        self.dense2 = nn.Linear(hidden, c)


class Block(nn.Module):
    """SegformerLayer: pre-LN efficient attention and Mix-FFN residuals."""

    def __init__(self, c, heads, sr_ratio, mlp_ratio, eps):
        super().__init__()
        self.heads, self.sr_ratio, self.eps = heads, sr_ratio, eps
        self.layer_norm_1 = nn.LayerNorm(c)
        self.attention = Attention(c, sr_ratio)
        self.layer_norm_2 = nn.LayerNorm(c)
        self.mlp = MixFFN(c, mlp_ratio * c)

    def _attention(self, x, hw):
        """(B, L, C) -> (B, L, C) (segformer.py:53-74)."""
        b, l, c = x.shape
        sa = self.attention.self
        q = F.linear(sa.query, x)
        kv_in = x
        if self.sr_ratio > 1:
            s = F.conv2d(sa.sr, x.reshape(b, *hw, c), stride=self.sr_ratio, padding="VALID")
            kv_in = F.layer_norm(sa.layer_norm, s.reshape(b, -1, c), eps=self.eps)
        k, v = F.linear(sa.key, kv_in), F.linear(sa.value, kv_in)

        def split(z):
            return z.reshape(b, z.shape[1], self.heads, c // self.heads)

        out = A.attend(split(q), split(k), split(v), impl="plain").reshape(b, l, c)
        return F.linear(self.attention.output["dense"], out)

    def _mix_ffn(self, x, hw):
        """dense1 -> 3x3 depthwise conv -> GELU -> dense2 (segformer.py:77-86)."""
        b, l, _ = x.shape
        h = F.linear(self.mlp.dense1, x)
        hidden = h.shape[-1]
        h = F.conv2d(self.mlp.dwconv.dwconv, h.reshape(b, *hw, hidden), groups=hidden)
        return F.linear(self.mlp.dense2, F.gelu(h.reshape(b, l, hidden)))

    def forward(self, x, hw):
        x = x + self._attention(F.layer_norm(self.layer_norm_1, x, eps=self.eps), hw)
        return x + self._mix_ffn(F.layer_norm(self.layer_norm_2, x, eps=self.eps), hw)


class PatchEmbed(nn.Module):
    def __init__(self, c_in, c, patch, stride):
        super().__init__()
        self.proj = nn.Conv2d(c_in, c, patch, stride=stride, padding=patch // 2)
        self.layer_norm = nn.LayerNorm(c)


class Encoder(nn.Module):
    """The MiT encoder: x (B, H, W, 3) -> 4 stage features (B, Hi, Wi, Ci)."""

    def __init__(self, cfg: SegFormerConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embeddings = nn.ModuleList()
        self.block = nn.ModuleList()
        self.layer_norm = nn.ModuleList()
        c_in = 3
        for i, c in enumerate(cfg.hidden_sizes):
            self.patch_embeddings.append(PatchEmbed(c_in, c, cfg.patch_sizes[i], cfg.strides[i]))
            self.block.append(nn.ModuleList(
                Block(c, cfg.num_attention_heads[i], cfg.sr_ratios[i], cfg.mlp_ratio,
                      cfg.layer_norm_eps) for _ in range(cfg.depths[i])))
            self.layer_norm.append(nn.LayerNorm(c))
            c_in = c

    def forward(self, x):
        cfg, eps = self.cfg, self.cfg.layer_norm_eps
        feats = []
        h = x
        for i in range(len(cfg.hidden_sizes)):
            pe = self.patch_embeddings[i]
            pad = cfg.patch_sizes[i] // 2
            h = F.conv2d(pe.proj, h, stride=cfg.strides[i], padding=((pad, pad), (pad, pad)))
            b, hh, ww, c = h.shape
            h = F.layer_norm(pe.layer_norm, h.reshape(b, hh * ww, c), eps=eps)
            for blk in self.block[i]:
                h = blk(h, (hh, ww))
            h = F.layer_norm(self.layer_norm[i], h, eps=eps).reshape(b, hh, ww, c)
            feats.append(h)
        return feats


class DecodeHead(nn.Module):
    """The all-MLP head (SegformerDecodeHead): per-stage linear -> upsample to
    1/4 -> concat reversed -> 1x1 fuse + BN + ReLU -> classifier."""

    def __init__(self, cfg: SegFormerConfig):
        super().__init__()
        d = cfg.decoder_hidden_size
        self.linear_c = nn.ModuleList(_Linear(c, d) for c in cfg.hidden_sizes)
        self.linear_fuse = nn.Conv2d(len(cfg.hidden_sizes) * d, d, 1, bias=False)
        self.batch_norm = nn.BatchNorm2d(d)
        self.classifier = nn.Conv2d(d, cfg.num_labels, 1)

    def forward(self, feats):
        target_hw = feats[0].shape[1:3]
        ups = []
        for lin, f in zip(self.linear_c, feats):
            b, hh, ww, c = f.shape
            z = F.linear(lin.proj, f.reshape(b, hh * ww, c)).reshape(b, hh, ww, -1)
            if (hh, ww) != tuple(target_hw):
                z = resize_bilinear(z, target_hw)
            ups.append(z)
        h = F.conv2d(self.linear_fuse, torch.cat(ups[::-1], dim=-1))
        h = torch.relu(F.batch_norm(self.batch_norm, h))
        return F.conv2d(self.classifier, h)


class _Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.encoder = Encoder(cfg)


class SegFormer(nn.Module):
    """SegformerForSemanticSegmentation: (B, H, W, 3) normalized image ->
    logits (B, H/4, W/4, num_labels)."""

    def __init__(self, cfg: SegFormerConfig = SegFormerConfig()):
        super().__init__()
        self.cfg = cfg
        self.segformer = _Backbone(cfg)
        self.decode_head = DecodeHead(cfg)

    def forward(self, x):
        return self.decode_head(self.segformer.encoder(x))


def logits_full(model: SegFormer, image_01):
    """image_01 (H, W, 3) float in [0, 1] -> logits (H, W, classes) in fp32:
    the imagenet normalization, the model, and the logits upsampled back to
    the input size (pipeline_segment.py semantics via mmseg/HF processors)."""
    mean = torch.tensor(IMAGENET_MEAN, device=image_01.device)
    std = torch.tensor(IMAGENET_STD, device=image_01.device)
    x = (image_01 - mean) / std
    dtype = next(model.parameters()).dtype
    logits = model(x[None].to(dtype))
    return resize_bilinear(logits, image_01.shape[:2])[0]


def segment(model: SegFormer, image_01):
    """image_01 (H, W, 3) float in [0, 1] -> (H, W) int32 class ids
    (segformer.py:139-150)."""
    return torch.argmax(logits_full(model, image_01), dim=-1).to(torch.int32)


def load_hf_state_dict(model: SegFormer, sd) -> SegFormer:
    """Load a SegFormer state dict in HF's layout (the whole
    SegformerForSemanticSegmentation, or a bare 'encoder.*' + 'decode_head.*'
    dict as JAX's trees flatten to; arrays or tensors) strictly, but for
    BatchNorm's num_batches_tracked, which inference never reads."""
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        v = torch.as_tensor(v)
        out["segformer." + k if k.startswith("encoder.") else k] = (
            v.float() if v.is_floating_point() else v)
    missing, unexpected = model.load_state_dict(out, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"SegFormer state dict: missing {missing}, unexpected {unexpected}")
    return model
