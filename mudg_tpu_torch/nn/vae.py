"""SD-style KL autoencoder (f=8, z=4), the frozen first stage.

Port of `mudg_tpu/nn/vae.py` (reference `lvdm/models/autoencoder.py`,
`lvdm/modules/networks/ae_modules.py`). Channels-last; `state_dict()` keys
equal the JAX tree paths (encoder.*, decoder.*, quant_conv, post_quant_conv).
Video frames fold into the batch as (B*T, H, W, C) and go through the 2-D
networks in chunks of `chunk` frames. Every layer is plain torch: the mid-block
attention is single-head matmul + fp32 softmax, as the JAX package runs it
(impl="xla").
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from . import functional as F
from .attention import attend
from ..core.distributions import DiagonalGaussian
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """ddconfig of the first stage (configs/stage1.../config.yaml:71-84)."""
    ch: int = 128
    out_ch: int = 3
    in_channels: int = 3
    z_channels: int = 4
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    double_z: bool = True
    embed_dim: int = 4
    scale_factor: float = 0.18215


class ResnetBlock(nn.Module):
    """AE ResnetBlock without temb (ae_modules.py:151-210)."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, c_in)
        self.conv1 = nn.Conv2d(c_in, c_out, 3)
        self.norm2 = nn.GroupNorm(32, c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3)
        if c_in != c_out:
            self.nin_shortcut = nn.Conv2d(c_in, c_out, 1)

    def forward(self, x):
        h = F.conv2d(self.conv1, F.silu(F.group_norm(self.norm1, x, eps=1e-6)))
        h = F.conv2d(self.conv2, F.silu(F.group_norm(self.norm2, h, eps=1e-6)))
        if hasattr(self, "nin_shortcut"):
            x = F.conv2d(self.nin_shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over H*W, 1x1-conv projections
    (ae_modules.py:26-78)."""

    def __init__(self, c):
        super().__init__()
        self.norm = nn.GroupNorm(32, c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        n, h, w, c = x.shape
        hn = F.group_norm(self.norm, x, eps=1e-6)
        q, k, v = (F.conv2d(m, hn).reshape(n, h * w, 1, c) for m in (self.q, self.k, self.v))
        return x + F.conv2d(self.proj_out, attend(q, k, v, impl="plain").reshape(n, h, w, c))


class _Resample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)


def _mid(c):
    return nn.ModuleDict({"block_1": ResnetBlock(c, c), "attn_1": AttnBlock(c),
                          "block_2": ResnetBlock(c, c)})


def _run_mid(mid, h):
    return mid["block_2"](mid["attn_1"](mid["block_1"](h)))


class Encoder(nn.Module):
    """Encoder (ae_modules.py:364-463): x (N, H, W, 3) -> moments (N, H/8, W/8, 2z)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.ch
        in_mult = (1,) + tuple(cfg.ch_mult)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch, 3)
        self.down = nn.ModuleDict()
        block_in = ch
        for i, mult in enumerate(cfg.ch_mult):
            block_in = ch * in_mult[i]
            blocks = nn.ModuleDict()
            for j in range(cfg.num_res_blocks):
                blocks[str(j)] = ResnetBlock(block_in, ch * mult)
                block_in = ch * mult
            level = nn.ModuleDict({"block": blocks})
            if i != len(cfg.ch_mult) - 1:
                level["downsample"] = _Resample(block_in)
            self.down[str(i)] = level
        self.mid = _mid(block_in)
        self.norm_out = nn.GroupNorm(32, block_in)
        self.conv_out = nn.Conv2d(block_in, 2 * cfg.z_channels if cfg.double_z
                                  else cfg.z_channels, 3)

    def forward(self, x):
        h = F.conv2d(self.conv_in, x)
        for i, level in enumerate(self.down.values()):
            for blk in level["block"].values():
                h = blk(h)
            if "downsample" in level:
                # torch pads (0, 1, 0, 1) then a VALID stride-2 conv (ae_modules.py:90-109)
                h = F.conv2d(level["downsample"].conv, h, stride=2, padding=((0, 1), (0, 1)))
        h = _run_mid(self.mid, h)
        return F.conv2d(self.conv_out, F.silu(F.group_norm(self.norm_out, h, eps=1e-6)))


class Decoder(nn.Module):
    """Decoder (ae_modules.py:466-578): z (N, h, w, z) -> (N, 8h, 8w, 3)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.ch
        block_in = ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3)
        self.mid = _mid(block_in)
        self.up = nn.ModuleDict()
        for i in reversed(range(len(cfg.ch_mult))):
            blocks = nn.ModuleDict()
            for j in range(cfg.num_res_blocks + 1):
                blocks[str(j)] = ResnetBlock(block_in, ch * cfg.ch_mult[i])
                block_in = ch * cfg.ch_mult[i]
            level = nn.ModuleDict({"block": blocks})
            if i != 0:
                level["upsample"] = _Resample(block_in)
            self.up[str(i)] = level
        self.norm_out = nn.GroupNorm(32, block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3)
        self.levels = len(cfg.ch_mult)

    def forward(self, z):
        h = _run_mid(self.mid, F.conv2d(self.conv_in, z))
        for i in reversed(range(self.levels)):
            level = self.up[str(i)]
            for blk in level["block"].values():
                h = blk(h)
            if "upsample" in level:
                h = F.conv2d(level["upsample"].conv, F.upsample_nearest_2x(h))
        return F.conv2d(self.conv_out, F.silu(F.group_norm(self.norm_out, h, eps=1e-6)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(zc, 2 * cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def encode_moments(self, x):
        """The posterior moments (mean | logvar) of x (autoencoder.py:97-102)."""
        return F.conv2d(self.quant_conv, self.encoder(x))

    def encode(self, x, generator: torch.Generator | None = None):
        """Scaled latents from the posterior moments: a sample with a
        generator, else the mode (ddpm3d.py:611-618)."""
        return sample_scaled(self.cfg, self.encode_moments(x), generator)

    def decode(self, z):
        """AutoencoderKL.decode with the 1/scale_factor pre-scale (ddpm3d.py:654-656)."""
        return self.decoder(F.conv2d(self.post_quant_conv, z / self.cfg.scale_factor))


def sample_scaled(cfg: VAEConfig, moments, generator: torch.Generator | None = None):
    """Posterior moments (..., 2z) -> scaled latents (..., z): a sample with a
    generator, else the mode, times scale_factor (vae.py:148-154)."""
    post = DiagonalGaussian.from_moments(moments)
    z = post.sample(generator) if generator is not None else post.mode()
    return cfg.scale_factor * z


def _chunked(fn, x, chunk: int):
    n = x.shape[0]
    if chunk <= 0 or n <= chunk:
        return fn(x)
    if n % chunk:
        raise ValueError(f"leading dim {n} not divisible by chunk {chunk}")
    return torch.cat([fn(x[i:i + chunk]) for i in range(0, n, chunk)])


def encode_video(vae: AutoencoderKL, x, generator=None, chunk: int = 1):
    """x (B, T, H, W, 3) -> (B, T, H/8, W/8, z); chunk = frames per call."""
    b, t = x.shape[:2]

    def encode(xc):
        with profiling.span("vae.encode"):
            return vae.encode(xc, generator)

    z = _chunked(encode, x.reshape(b * t, *x.shape[2:]), chunk)
    return z.reshape(b, t, *z.shape[1:])


def encode_moments_video(vae: AutoencoderKL, x, chunk: int = 1):
    """x (B, T, H, W, 3) -> posterior moments (B, T, H/8, W/8, 2z)
    (vae.py:128-141); chunk = frames per call."""
    b, t = x.shape[:2]
    m = _chunked(vae.encode_moments, x.reshape(b * t, *x.shape[2:]), chunk)
    return m.reshape(b, t, *m.shape[1:])


def decode_video(vae: AutoencoderKL, z, chunk: int = 1):
    """z (B, T, h, w, zc) -> (B, T, 8h, 8w, 3); chunk = frames per call."""
    b, t = z.shape[:2]

    def decode(zc):
        with profiling.span("vae.decode"):
            return vae.decode(zc)

    x = _chunked(decode, z.reshape(b * t, *z.shape[2:]), chunk)
    return x.reshape(b, t, *x.shape[1:])
