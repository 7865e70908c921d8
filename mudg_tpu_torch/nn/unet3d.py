"""DynamiCrafter-style 3D video UNet denoiser.

Port of `mudg_tpu/nn/unet3d.py` (reference `lvdm/modules/networks/
openaimodel3d.py:19-628`). The static block plan drives both module
construction and the forward pass, so `state_dict()` keys equal the JAX tree
paths (input_blocks.N.M..., including the reference's 'temopral_conv'
spelling). Activations are channels-last: spatial layers see (B*T, H, W, C),
temporal layers (B, T, H, W, C).

Training: `impl="train"` selects the JAX training dispatch (the kernels
with a backward kernel, as autograd ops; the temporal conv plain, no kernel
4), a `generator` turns on dropout at `cfg.dropout` in every ResBlock and in
stages 2-4 of every TemporalConvBlock (unet3d.py:170-201), and `remat`
runs every input, middle and output block under `torch.utils.checkpoint`:
True (or "full") recomputes the whole block, a policy name of
`nn/remat.POLICIES` (unet3d.py:344-406: dots, dots_small, dots_ln,
dots_attn, except_ff, dots_gn, convs, names) keeps what the policy names;
`init_attn` is not checkpointed. `sp` (a `parallel/sp.SeqSharding`) runs
the forward sequence-parallel on the plain path: the frame rows of the
spatial layers and W of the temporal ones sharded over the seq ranks, an
all-to-all at each layout transition (unet3d.py:207,210,247,257,413,420),
the temporal GroupNorms' statistics summed over the ranks, the output
all-gathered. Under dropout each rank draws its own masks: the block seeds
drawn from the generator are offset by `dropout_rank` (set per rank by
`train/step.py`), so ranks that hold different samples or positions draw
different masks. The options that the MDM configs leave off run as the
JAX UNet runs them (unet3d.py:466-525): relative-position tables in every
temporal transformer (init_attn's too) and the causal mask in the block
ones (init_attn is never causal), the cross-context temporal path
(temporal_selfatt_only=False; init_attn's too), and the joint task
attention in the input blocks' spatial transformers (num_tasks task-major
chunks of the batch); none of these runs sequence-parallel.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Sequence

import torch
from torch import nn

from . import attention as A
from .. import quant as Q
from . import functional as F
from . import remat as R
from ..core.schedules import timestep_embedding
from ..kernels import tconv as TC
from ..parallel import sp as SP


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Mirrors mudg_tpu.nn.unet3d.UNetConfig (reference config.yaml:32-64)."""
    in_channels: int = 12
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    dropout: float = 0.1
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    use_linear: bool = True
    temporal_conv: bool = True
    temporal_attention: bool = True
    temporal_selfatt_only: bool = True
    use_relative_position: bool = False
    use_causal_attention: bool = False
    temporal_length: int = 16
    addition_attention: bool = True
    image_cross_attention: bool = True
    image_cross_attention_scale_learnable: bool = False
    default_fs: int = 10
    fs_condition: bool = True
    class_label_condition: bool = True
    domain_cross_attention: bool = False
    num_tasks: int = 1
    text_context_len: int = 77
    image_tokens_per_frame: int = 16


def block_plan(cfg: UNetConfig):
    """(input_blocks, middle_block, output_blocks) as lists of
    (layer_type, args); identical to mudg_tpu.nn.unet3d.block_plan."""
    mc = cfg.model_channels
    tdim = 4 * mc

    def heads(ch):
        return ch // cfg.num_head_channels

    inp = [[("conv_in", dict(c_in=cfg.in_channels, c_out=mc))]]
    input_chans = [mc]
    ch, ds = mc, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            block = [("res", dict(c_in=ch, c_out=mult * mc, emb=tdim,
                                  temporal=cfg.temporal_conv))]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                block.append(("spatial", dict(ch=ch, heads=heads(ch),
                                              domain=cfg.domain_cross_attention)))
                if cfg.temporal_attention:
                    block.append(("temporal", dict(ch=ch, heads=heads(ch))))
            inp.append(block)
            input_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            inp.append([("down", dict(ch=ch))])
            input_chans.append(ch)
            ds *= 2

    mid = [
        ("res", dict(c_in=ch, c_out=ch, emb=tdim, temporal=cfg.temporal_conv)),
        ("spatial", dict(ch=ch, heads=heads(ch))),
    ]
    if cfg.temporal_attention:
        mid.append(("temporal", dict(ch=ch, heads=heads(ch))))
    mid.append(("res", dict(c_in=ch, c_out=ch, emb=tdim, temporal=cfg.temporal_conv)))

    out = []
    chans = list(input_chans)
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            block = [("res", dict(c_in=ch + ich, c_out=mult * mc, emb=tdim,
                                  temporal=cfg.temporal_conv))]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                block.append(("spatial", dict(ch=ch, heads=heads(ch))))
                if cfg.temporal_attention:
                    block.append(("temporal", dict(ch=ch, heads=heads(ch))))
            if level and i == cfg.num_res_blocks:
                block.append(("up", dict(ch=ch)))
                ds //= 2
            out.append(block)
    return inp, mid, out


def dropout(x, rate: float, generator: torch.Generator):
    """Inverted dropout (unet3d.py:181-185): each element kept with
    probability 1 - rate, kept elements scaled by 1 / (1 - rate), in x's
    dtype; the keep mask is drawn from `generator`."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device)).to(x.dtype)


def _stage(c, key):
    return nn.ModuleDict({"0": nn.GroupNorm(32, c), key: nn.Conv3d(c, c, (3, 1, 1))})


class TemporalConvBlock(nn.Module):
    """Four GN -> SiLU -> Conv3d (3,1,1) stages and a residual
    (openaimodel3d.py:239-279); each stage is kernel 4 where eligible."""

    def __init__(self, c):
        super().__init__()
        self.conv1 = _stage(c, "2")
        self.conv2 = _stage(c, "3")
        self.conv3 = _stage(c, "3")
        self.conv4 = _stage(c, "3")
        self.kernel_packs = None

    def stages(self):
        return [(self.conv1["0"], self.conv1["2"]), (self.conv2["0"], self.conv2["3"]),
                (self.conv3["0"], self.conv3["3"]), (self.conv4["0"], self.conv4["3"])]

    def pack_kernel_weights(self):
        """Kernel 4's weights, where every stage's conv is float and C fits."""
        stages = self.stages()
        fits = (all(Q.is_float(conv) for _, conv in stages)
                and self.conv1["2"].weight.shape[0] <= TC.MAX_C)
        self.kernel_packs = [TC.pack_tconv(conv, norm) for norm, conv in stages] if fits else None

    def forward(self, x, impl="auto", drop=None, sp=None):
        """drop: None, or the dropout applied before the conv of stages 2-4;
        sp: a sequence-parallel sharding (x a block of W), whose ranks the
        GroupNorms sum their statistics over."""
        stages = self.stages()
        # MUDG_FUSED_TCONV=0 keeps the plain stages (the JAX switch,
        # mudg_tpu/nn/unet3d.py:148-151)
        if (impl == "auto" and drop is None and os.environ.get("MUDG_FUSED_TCONV", "1") == "1"
                and all(Q.is_float(conv) and TC.eligible(x.shape, x.dtype, conv.weight.shape)
                        for _, conv in stages)):
            packs = self.kernel_packs or [None] * 4
            h = x.contiguous()
            for (norm, conv), pack in zip(stages, packs):
                h = TC.fused_gn_silu_tconv(h, norm, conv, pack)
            return x + h
        h = x
        for i, (norm, conv) in enumerate(stages):
            h = F.silu(F.group_norm(norm, h, **SP.kw(sp)))
            if i and drop is not None:
                h = drop(h)
            h = F.temporal_conv311(conv, h)
        return x + h


class ResBlock(nn.Module):
    """ResBlock (+ TemporalConvBlock), openaimodel3d.py:109-236."""

    def __init__(self, c_in, c_out, emb, temporal):
        super().__init__()
        self.in_layers = nn.ModuleDict({"0": nn.GroupNorm(32, c_in),
                                        "2": nn.Conv2d(c_in, c_out, 3)})
        self.emb_layers = nn.ModuleDict({"1": nn.Linear(emb, c_out)})
        self.out_layers = nn.ModuleDict({"0": nn.GroupNorm(32, c_out),
                                         "3": nn.Conv2d(c_out, c_out, 3)})
        if c_in != c_out:
            self.skip_connection = nn.Conv2d(c_in, c_out, 1)
        if temporal:
            self.temopral_conv = TemporalConvBlock(c_out)

    def forward(self, x, emb, batch_size, impl="auto", drop=None, sp=None):
        """x (B*T, H, W, C), emb (B*T, emb_dim); drop: None, or the dropout
        applied before the output conv and in the temporal conv block; sp:
        x a block of the frame rows, the temporal conv block run on a block
        of W between two all-to-alls."""
        h = F.conv2d(self.in_layers["2"], F.silu(F.group_norm(self.in_layers["0"], x)))
        h = h + F.linear(self.emb_layers["1"], F.silu(emb)).to(h.dtype)[:, None, None, :]
        h = F.silu(F.group_norm(self.out_layers["0"], h))
        if drop is not None:
            h = drop(h)
        h = F.conv2d(self.out_layers["3"], h)
        if hasattr(self, "skip_connection"):
            x = F.conv2d(self.skip_connection, x)
        h = x + h
        if hasattr(self, "temopral_conv"):
            ww = h.shape[2]
            hv = SP.to_video(h, batch_size, sp)
            h = SP.to_rows(self.temopral_conv(hv, impl=impl, drop=drop, **SP.kw(sp)), sp, ww)
        return h


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3)

    def forward(self, x):
        # torch pad=1, stride 2 (openaimodel3d.py:51-77)
        return F.conv2d(self.op, x, stride=2, padding=((1, 1), (1, 1)))


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3)

    def forward(self, x):
        return F.conv2d(self.conv, F.upsample_nearest_2x(x))


def _embed_mlp(mc, tdim):
    return nn.Sequential(nn.Linear(mc, tdim), nn.SiLU(), nn.Linear(tdim, tdim))


class UNet3D(nn.Module):
    """UNetModel (openaimodel3d.py:567-628). Build a full-size model on the
    meta device and move it with `to_empty` before loading weights."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        tdim = 4 * mc
        self.time_embed = _embed_mlp(mc, tdim)
        if cfg.class_label_condition:
            self.class_embed = _embed_mlp(mc, tdim)
        if cfg.fs_condition:
            self.fps_embedding = _embed_mlp(mc, tdim)
        if cfg.addition_attention:
            self.init_attn = nn.ModuleDict({"0": A.TemporalTransformer(
                mc, heads=8, dim_head=cfg.num_head_channels,
                depth=cfg.transformer_depth, use_linear=False, **self._temporal_options())})
        inp_plan, mid_plan, out_plan = block_plan(cfg)
        self.input_blocks = nn.ModuleDict({
            str(i): self._make_block(plan) for i, plan in enumerate(inp_plan)})
        self.middle_block = self._make_block(mid_plan)
        self.output_blocks = nn.ModuleDict({
            str(i): self._make_block(plan) for i, plan in enumerate(out_plan)})
        self.out = nn.ModuleDict({"0": nn.GroupNorm(32, mc),
                                  "2": nn.Conv2d(mc, cfg.out_channels, 3)})

    def _temporal_options(self):
        cfg = self.cfg
        return dict(relative_position=cfg.use_relative_position,
                    temporal_length=cfg.temporal_length,
                    context_dim=None if cfg.temporal_selfatt_only else cfg.context_dim)

    def _make_layer(self, ltype, args):
        cfg = self.cfg
        if ltype == "conv_in":
            return nn.Conv2d(args["c_in"], args["c_out"], 3)
        if ltype == "res":
            return ResBlock(args["c_in"], args["c_out"], args["emb"], args["temporal"])
        if ltype == "spatial":
            return A.SpatialTransformer(
                args["ch"], heads=args["heads"], dim_head=cfg.num_head_channels,
                depth=cfg.transformer_depth, context_dim=cfg.context_dim,
                use_linear=cfg.use_linear, image_cross=cfg.image_cross_attention,
                alpha_learnable=cfg.image_cross_attention_scale_learnable,
                domain_cross=args.get("domain", False))
        if ltype == "temporal":
            return A.TemporalTransformer(
                args["ch"], heads=args["heads"], dim_head=cfg.num_head_channels,
                depth=cfg.transformer_depth, use_linear=cfg.use_linear,
                **self._temporal_options())
        if ltype == "down":
            return Downsample(args["ch"])
        if ltype == "up":
            return Upsample(args["ch"])
        raise ValueError(ltype)

    def _make_block(self, plan):
        return nn.ModuleDict({str(j): self._make_layer(lt, a) for j, (lt, a) in enumerate(plan)})

    def _run_block(self, block, plan, h, emb, context, batch_size, impl, seed=None, sp=None):
        """One block of the plan. seed: None, or the seed of this block's own
        dropout generator (made here, so that a checkpointed block's
        recompute draws the same masks); sp: the sequence-parallel sharding."""
        cfg = self.cfg
        drop = None
        if seed is not None:
            gen = torch.Generator(device=h.device).manual_seed(seed)
            drop = functools.partial(dropout, rate=cfg.dropout, generator=gen)
        for idx, (ltype, _) in enumerate(plan):
            m = block[str(idx)]
            if ltype == "conv_in":
                h = F.conv2d(m, h)
            elif ltype == "res":
                h = m(h, emb, batch_size, impl=impl, drop=drop, **SP.kw(sp))
            elif ltype == "spatial":
                h = m(h, context, image_cross=cfg.image_cross_attention,
                      text_len=cfg.text_context_len, num_tasks=cfg.num_tasks, impl=impl)
            elif ltype == "temporal":
                # the context is per-frame rows (B*T, L, D), the layout the
                # cross-context path takes (openaimodel3d.py:581-588)
                ww = h.shape[2]
                h = SP.to_rows(m(SP.to_video(h, batch_size, sp),
                                 None if cfg.temporal_selfatt_only else context,
                                 causal=cfg.use_causal_attention,
                                 temporal_length=cfg.temporal_length, impl=impl,
                                 **SP.kw(sp)), sp, ww)
            else:
                h = m(h)
        return h

    dropout_rank = 0   # offsets the block seeds: each rank's own masks

    def forward(self, x, timesteps, context, *, c_label=None, fs=None, impl="auto",
                remat=False, generator: torch.Generator | None = None, sp=None):
        """x (B, T, H, W, C_in), timesteps (B,), context (B, 77 + T*16, D) or
        (B, L, D), c_label (B,), fs (B,) -> (B, T, H, W, out_channels).
        remat: False, True (full per-block recompute) or a policy name of
        `nn/remat.POLICIES`; generator: dropout on, each block drawing from
        its own generator seeded from this one; sp: a `parallel/sp.SeqSharding`
        (impl "plain" only, as JAX's requires "xla", unet3d.py:324-330): every
        rank passes the whole inputs and gets the whole output."""
        cfg = self.cfg
        if remat is not False:
            R.policy_names(remat)   # raises for an unknown policy
        if sp is not None and impl != "plain":
            raise ValueError(f"sequence parallelism requires impl='plain', got {impl!r}")
        if sp is not None and (cfg.domain_cross_attention or not cfg.temporal_selfatt_only):
            raise ValueError("joint task and cross-context temporal attention do not run "
                             "sequence-parallel")
        b, t, hh, ww, _ = x.shape
        mc = cfg.model_channels
        dtype = x.dtype

        def mlp(seq, v):
            return F.linear(seq[2], F.silu(F.linear(seq[0], v)))

        emb = mlp(self.time_embed, timestep_embedding(timesteps, mc).to(dtype))
        if cfg.class_label_condition:
            if c_label is None:
                raise ValueError("class_label is required")
            emb = emb + mlp(self.class_embed, timestep_embedding(c_label, mc).to(dtype))

        # 77 text tokens broadcast over frames, 16 image tokens per frame to
        # their frame (openaimodel3d.py:581-588)
        if context.shape[1] == cfg.text_context_len + t * cfg.image_tokens_per_frame:
            ctx_text = context[:, :cfg.text_context_len].repeat_interleave(t, dim=0)
            ctx_img = context[:, cfg.text_context_len:].reshape(
                b * t, cfg.image_tokens_per_frame, -1)
            context = torch.cat([ctx_text, ctx_img], dim=1)
        else:
            context = context.repeat_interleave(t, dim=0)
        emb = emb.repeat_interleave(t, dim=0)

        if cfg.fs_condition:
            if fs is None:
                fs = torch.full((b,), cfg.default_fs, device=x.device, dtype=torch.int64)
            fs_emb = mlp(self.fps_embedding, timestep_embedding(fs, mc).to(dtype))
            emb = emb + fs_emb.repeat_interleave(t, dim=0)

        h = x.reshape(b * t, hh, ww, x.shape[-1])
        if sp is not None:
            sp = sp.for_clip(t)
            h, emb, context = SP.rows(h, sp), SP.rows(emb, sp), SP.rows(context, sp)
        inp_plan, mid_plan, out_plan = block_plan(cfg)
        n_blocks = len(inp_plan) + 1 + len(out_plan)
        seeds = [None] * n_blocks
        if generator is not None and cfg.dropout > 0.0:
            seeds = torch.randint(0, 2**62, (n_blocks,), generator=generator,
                                  device=generator.device).tolist()
            seeds = [(s + self.dropout_rank * 0x9E3779B97F4A7C15) % 2**62 for s in seeds]
        seeds = iter(seeds)

        def run(block, plan, h):
            args = (block, plan, h, emb, context, b, impl, next(seeds), sp)
            if remat is not False:
                # dropout draws from per-block generators, so no global RNG
                # state needs saving for the recompute
                with R.block():
                    return R.checkpoint(self._run_block, *args, remat=remat)
            return self._run_block(*args)

        hs = []
        for i, plan in enumerate(inp_plan):
            h = run(self.input_blocks[str(i)], plan, h)
            if i == 0 and cfg.addition_attention:
                w_ = h.shape[2]
                h = SP.to_rows(self.init_attn["0"](
                    SP.to_video(h, b, sp), None if cfg.temporal_selfatt_only else context,
                    temporal_length=cfg.temporal_length, impl=impl, **SP.kw(sp)), sp, w_)
            hs.append(h)
        h = run(self.middle_block, mid_plan, h)
        for i, plan in enumerate(out_plan):
            h = torch.cat([h, hs.pop()], dim=-1)
            h = run(self.output_blocks[str(i)], plan, h)
        h = F.silu(F.group_norm(self.out["0"], h))
        y = SP.gather(F.conv2d(self.out["2"], h), 0, sp)
        return y.reshape(b, t, hh, ww, cfg.out_channels)
