"""The plain reference of the MuDG multi-modal diffusion model (MDM).

Plain PyTorch in float32, written from the published architecture
(DynamiCrafter's 3D video UNet with MuDG's conditioning, the SD KL
autoencoder, OpenCLIP ViT-H-14 text and vision towers, the IP-Adapter
resampler). Every function reads its weights from a flat state dict `P`
(name -> tensor) under the names of the model's published checkpoint
layout: unet.*, vae.*, image_proj.*, clip_text.*, clip_image.*.
Activations are channels-last: images (N, H, W, C), videos (B, T, H, W, C).

This module imports nothing of the program under test. `param_shapes`
lists every weight the configuration holds; the benchmark draws a state
dict of those names from the seed and hands it to the program and to this
reference alike.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

LOGITS_BUDGET = 2 << 30    # fp32 logits materialised at once per attention call
FP8_MAX = 448.0
_FP8 = [False]


@contextlib.contextmanager
def fp8():
    """The reference in the precision below bf16, for controls: inside,
    each operand of every convolution, linear layer and attention product
    (and every value the callers pass through `lowered`) is first rounded
    to float8 e4m3 with a scale per tensor (its largest magnitude to 448);
    the products still sum in float32."""
    _FP8[0] = True
    try:
        yield
    finally:
        _FP8[0] = False


def lowered(x):
    """x as the reference's precision holds it: itself, or under `fp8`
    rounded to float8 e4m3."""
    if not _FP8[0]:
        return x
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------

def _lin(out, inp, bias=True):
    d = {"weight": (out, inp)}
    if bias:
        d["bias"] = (out,)
    return d


def _conv(out, inp, k, bias=True):
    d = {"weight": (out, inp, *k)}
    if bias:
        d["bias"] = (out,)
    return d


def _norm(c):
    return {"weight": (c,), "bias": (c,)}


def _flat(prefix, tree, out):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            _flat(name, v, out)
        else:
            out[name] = tuple(v)
    return out


def unet_plan(u: dict):
    """(input_blocks, middle_block, output_blocks) as lists of layers
    (type, args) of DynamiCrafter's UNetModel (openaimodel3d.py:567-628)."""
    mc = u["model_channels"]
    tdim = 4 * mc
    inp = [[("conv_in", dict(c_in=u["in_channels"], c_out=mc))]]
    chans = [mc]
    ch, ds = mc, 1
    levels = list(u["channel_mult"])
    for level, mult in enumerate(levels):
        for _ in range(u["num_res_blocks"]):
            block = [("res", dict(c_in=ch, c_out=mult * mc, emb=tdim))]
            ch = mult * mc
            if ds in u["attention_resolutions"]:
                block += [("spatial", dict(ch=ch)), ("temporal", dict(ch=ch))]
            inp.append(block)
            chans.append(ch)
        if level != len(levels) - 1:
            inp.append([("down", dict(ch=ch))])
            chans.append(ch)
            ds *= 2
    mid = [("res", dict(c_in=ch, c_out=ch, emb=tdim)), ("spatial", dict(ch=ch)),
           ("temporal", dict(ch=ch)), ("res", dict(c_in=ch, c_out=ch, emb=tdim))]
    out = []
    for level, mult in list(enumerate(levels))[::-1]:
        for i in range(u["num_res_blocks"] + 1):
            ich = chans.pop()
            block = [("res", dict(c_in=ch + ich, c_out=mult * mc, emb=tdim))]
            ch = mult * mc
            if ds in u["attention_resolutions"]:
                block += [("spatial", dict(ch=ch)), ("temporal", dict(ch=ch))]
            if level and i == u["num_res_blocks"]:
                block.append(("up", dict(ch=ch)))
                ds //= 2
            out.append(block)
    return inp, mid, out


def _block_params(dim, ctx_dim, image_cross):
    attn2 = {"to_q": _lin(dim, dim, False), "to_k": _lin(dim, ctx_dim, False),
             "to_v": _lin(dim, ctx_dim, False), "to_out": {"0": _lin(dim, dim)}}
    if image_cross:
        attn2["to_k_ip"] = _lin(dim, ctx_dim, False)
        attn2["to_v_ip"] = _lin(dim, ctx_dim, False)
    return {"attn1": {"to_q": _lin(dim, dim, False), "to_k": _lin(dim, dim, False),
                      "to_v": _lin(dim, dim, False), "to_out": {"0": _lin(dim, dim)}},
            "attn2": attn2,
            "ff": {"net": {"0": {"proj": _lin(8 * dim, dim)}, "2": _lin(dim, 4 * dim)}},
            "norm1": _norm(dim), "norm2": _norm(dim), "norm3": _norm(dim)}


def _transformer_params(ch, inner, ctx_dim, image_cross, linear):
    proj_in = _lin(inner, ch) if linear else _conv(inner, ch, (1,))
    proj_out = _lin(ch, inner) if linear else _conv(ch, inner, (1,))
    return {"norm": _norm(ch), "proj_in": proj_in,
            "transformer_blocks": {"0": _block_params(inner, ctx_dim, image_cross)},
            "proj_out": proj_out}


def _res_params(c_in, c_out, emb):
    p = {"in_layers": {"0": _norm(c_in), "2": _conv(c_out, c_in, (3, 3))},
         "emb_layers": {"1": _lin(c_out, emb)},
         "out_layers": {"0": _norm(c_out), "3": _conv(c_out, c_out, (3, 3))},
         "temopral_conv": {f"conv{i}": {"0": _norm(c_out),
                                        ("2" if i == 1 else "3"): _conv(c_out, c_out, (3, 1, 1))}
                           for i in range(1, 5)}}
    if c_in != c_out:
        p["skip_connection"] = _conv(c_out, c_in, (1, 1))
    return p


def _layer_params(u, lt, a):
    if lt == "conv_in":
        return _conv(a["c_out"], a["c_in"], (3, 3))
    if lt == "res":
        return _res_params(a["c_in"], a["c_out"], a["emb"])
    if lt == "spatial":
        return _transformer_params(a["ch"], a["ch"], u["context_dim"], True, True)
    if lt == "temporal":
        return _transformer_params(a["ch"], a["ch"], a["ch"], False, True)
    if lt == "down":
        return {"op": _conv(a["ch"], a["ch"], (3, 3))}
    return {"conv": _conv(a["ch"], a["ch"], (3, 3))}


def unet_params(u):
    mc = u["model_channels"]
    tdim = 4 * mc
    emb = {"0": _lin(tdim, mc), "2": _lin(tdim, tdim)}
    inner = 8 * u["num_head_channels"]
    tree = {"time_embed": emb, "class_embed": emb, "fps_embedding": emb,
            "init_attn": {"0": _transformer_params(mc, inner, inner, False, False)}}
    inp, mid, out = unet_plan(u)
    tree["input_blocks"] = {str(i): {str(j): _layer_params(u, lt, a) for j, (lt, a) in
                                     enumerate(b)} for i, b in enumerate(inp)}
    tree["middle_block"] = {str(j): _layer_params(u, lt, a) for j, (lt, a) in enumerate(mid)}
    tree["output_blocks"] = {str(i): {str(j): _layer_params(u, lt, a) for j, (lt, a) in
                                      enumerate(b)} for i, b in enumerate(out)}
    tree["out"] = {"0": _norm(mc), "2": _conv(u["out_channels"], mc, (3, 3))}
    return tree


def _resnet_params(c_in, c_out):
    p = {"norm1": _norm(c_in), "conv1": _conv(c_out, c_in, (3, 3)),
         "norm2": _norm(c_out), "conv2": _conv(c_out, c_out, (3, 3))}
    if c_in != c_out:
        p["nin_shortcut"] = _conv(c_out, c_in, (1, 1))
    return p


def _mid_params(c):
    attn = {"norm": _norm(c), **{k: _conv(c, c, (1, 1)) for k in ("q", "k", "v", "proj_out")}}
    return {"block_1": _resnet_params(c, c), "attn_1": attn, "block_2": _resnet_params(c, c)}


def vae_params(v):
    ch, mult, nrb, z = v["ch"], list(v["ch_mult"]), v["num_res_blocks"], v["z_channels"]
    in_mult = [1] + mult
    down, block_in = {}, ch
    for i, m in enumerate(mult):
        block_in = ch * in_mult[i]
        blocks = {}
        for j in range(nrb):
            blocks[str(j)] = _resnet_params(block_in, ch * m)
            block_in = ch * m
        down[str(i)] = {"block": blocks}
        if i != len(mult) - 1:
            down[str(i)]["downsample"] = {"conv": _conv(block_in, block_in, (3, 3))}
    enc = {"conv_in": _conv(ch, v["in_channels"], (3, 3)), "down": down,
           "mid": _mid_params(block_in), "norm_out": _norm(block_in),
           "conv_out": _conv(2 * z if v["double_z"] else z, block_in, (3, 3))}
    block_in = ch * mult[-1]
    up = {}
    dec_mid = _mid_params(block_in)
    for i in reversed(range(len(mult))):
        blocks = {}
        for j in range(nrb + 1):
            blocks[str(j)] = _resnet_params(block_in, ch * mult[i])
            block_in = ch * mult[i]
        up[str(i)] = {"block": blocks}
        if i != 0:
            up[str(i)]["upsample"] = {"conv": _conv(block_in, block_in, (3, 3))}
    dec = {"conv_in": _conv(ch * mult[-1], z, (3, 3)), "mid": dec_mid,
           "up": up, "norm_out": _norm(block_in), "conv_out": _conv(v["out_ch"], block_in, (3, 3))}
    zc = 2 * z if v["double_z"] else z
    return {"encoder": enc, "decoder": dec,
            "quant_conv": _conv(2 * v["embed_dim"], zc, (1, 1)),
            "post_quant_conv": _conv(z, v["embed_dim"], (1, 1))}


def resampler_params(r):
    dim, inner = r["dim"], r["dim_head"] * r["heads"]
    q = r["num_queries"] * (r["video_length"] or 1)
    layer = {"0": {"norm1": _norm(dim), "norm2": _norm(dim), "to_q": _lin(inner, dim, False),
                   "to_kv": _lin(2 * inner, dim, False), "to_out": _lin(dim, inner, False)},
             "1": {"0": _norm(dim), "1": _lin(dim * r["ff_mult"], dim, False),
                   "3": _lin(dim, dim * r["ff_mult"], False)}}
    return {"latents": (1, q, dim), "proj_in": _lin(dim, r["embedding_dim"]),
            "proj_out": _lin(r["output_dim"], dim), "norm_out": _norm(r["output_dim"]),
            "layers": {str(i): layer for i in range(r["depth"])}}


def _clip_blocks(width, layers):
    blk = {"ln_1": _norm(width), "ln_2": _norm(width),
           "attn": {"in_proj_weight": (3 * width, width), "in_proj_bias": (3 * width,),
                    "out_proj": _lin(width, width)},
           "mlp": {"c_fc": _lin(4 * width, width), "c_proj": _lin(width, 4 * width)}}
    return {"resblocks": {str(i): blk for i in range(layers)}}


def text_params(t):
    return {"token_embedding": {"weight": (t["vocab_size"], t["width"])},
            "positional_embedding": (t["context_length"], t["width"]),
            "transformer": _clip_blocks(t["width"], t["layers"]), "ln_final": _norm(t["width"])}


def vision_params(v):
    grid = v["image_size"] // v["patch_size"]
    return {"conv1": _conv(v["width"], 3, (v["patch_size"], v["patch_size"]), False),
            "class_embedding": (v["width"],),
            "positional_embedding": (grid * grid + 1, v["width"]),
            "ln_pre": _norm(v["width"]), "transformer": _clip_blocks(v["width"], v["layers"])}


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """Every weight of the configuration `cfg` (a configuration file's
    dict), name -> shape, sorted by name."""
    out = {}
    _flat("unet", unet_params(cfg["unet"]), out)
    _flat("vae", vae_params(cfg["vae"]), out)
    _flat("image_proj", resampler_params(cfg["resampler"]), out)
    _flat("clip_text", text_params(cfg["clip_text"]), out)
    _flat("clip_image", vision_params(cfg["clip_image"]), out)
    return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def linear(P, name, x):
    w = P[name + ".weight"]
    return F.linear(lowered(x), lowered(w.reshape(w.shape[0], -1)), P.get(name + ".bias"))


def conv2d(P, name, x, stride=1, pad=None):
    """Channels-last 2-D convolution; pad None is k // 2 on every side, or
    (left, right, top, bottom)."""
    w = lowered(P[name + ".weight"])
    xc = lowered(x).permute(0, 3, 1, 2)
    if pad is None:
        y = F.conv2d(xc, w, P.get(name + ".bias"), stride=stride,
                     padding=(w.shape[2] // 2, w.shape[3] // 2))
    else:
        y = F.conv2d(F.pad(xc, pad), w, P.get(name + ".bias"), stride=stride)
    return y.permute(0, 2, 3, 1)


def group_norm(P, name, x, eps, groups=32):
    """GroupNorm of a channels-last tensor: statistics over every non-batch
    position of each group of channels."""
    n, c = x.shape[0], x.shape[-1]
    xg = x.reshape(n, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * P[name + ".weight"] + P[name + ".bias"]


def layer_norm(P, name, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], eps)


def attention(q, k, v, causal=False):
    """Softmax attention, q (B, Lq, H, D), k, v (B, Lk, H, D), scaled by
    D^-1/2, in blocks of (batch, head) pairs of at most LOGITS_BUDGET bytes
    of logits."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    per = max(1, LOGITS_BUDGET // (lq * lk * 4))
    q, k, v = (t.transpose(1, 2).reshape(b * h, -1, d) for t in (q, k, v))
    outs = []
    for i in range(0, b * h, per):
        s = torch.bmm(lowered(q[i:i + per]), lowered(k[i:i + per]).transpose(1, 2)) * d ** -0.5
        if causal:
            mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
            s = s.masked_fill(~mask, float("-inf"))
        outs.append(torch.bmm(lowered(torch.softmax(s, dim=-1)), lowered(v[i:i + per])))
    return torch.cat(outs).reshape(b, h, lq, d).transpose(1, 2)


def _heads(x, d=64):
    return x.reshape(*x.shape[:-1], x.shape[-1] // d, d)


def timestep_embedding(t, dim, max_period=10000):
    """Sinusoidal embedding [cos | sin] (lvdm utils_diffusion.py:8-28)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

def _cross_attention(P, name, x, context, dh, text_len=77):
    """CrossAttention: self-attention for context None; else keys over the
    context's first text_len tokens, plus the decoupled image keys over the
    rest where the module has them (ip scale 1)."""
    q = _heads(linear(P, name + ".to_q", x), dh)
    if context is None:
        k = _heads(linear(P, name + ".to_k", x), dh)
        v = _heads(linear(P, name + ".to_v", x), dh)
        out = attention(q, k, v)
    else:
        ctx = context[:, :text_len]
        out = attention(q, _heads(linear(P, name + ".to_k", ctx), dh),
                        _heads(linear(P, name + ".to_v", ctx), dh))
        if name + ".to_k_ip.weight" in P and context.shape[1] > text_len:
            img = context[:, text_len:]
            out = out + attention(q, _heads(linear(P, name + ".to_k_ip", img), dh),
                                  _heads(linear(P, name + ".to_v_ip", img), dh))
    return linear(P, name + ".to_out.0", out.reshape(*x.shape[:-1], -1))


def _transformer_block(P, name, x, context, dh):
    x = _cross_attention(P, name + ".attn1", layer_norm(P, name + ".norm1", x), None, dh) + x
    x = _cross_attention(P, name + ".attn2", layer_norm(P, name + ".norm2", x), context, dh) + x
    u, g = linear(P, name + ".ff.net.0.proj", layer_norm(P, name + ".norm3", x)).chunk(2, -1)
    return linear(P, name + ".ff.net.2", u * F.gelu(g)) + x


def _spatial(P, name, x, context, dh):
    n, h, w, c = x.shape
    y = group_norm(P, name + ".norm", x, 1e-6).reshape(n, h * w, c)
    y = linear(P, name + ".proj_in", y)
    y = _transformer_block(P, name + ".transformer_blocks.0", y, context, dh)
    return linear(P, name + ".proj_out", y).reshape(n, h, w, c) + x


def _temporal(P, name, x, dh):
    """Self-attention over the frames of each position; x (B, T, H, W, C)."""
    b, t, h, w, c = x.shape
    y = group_norm(P, name + ".norm", x, 1e-6)
    y = y.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
    y = linear(P, name + ".proj_in", y)
    y = _transformer_block(P, name + ".transformer_blocks.0", y, None, dh)
    y = linear(P, name + ".proj_out", y)
    return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4) + x


def _temporal_conv(P, name, x):
    """Four GroupNorm -> SiLU -> (3, 1, 1) conv stages and a residual;
    x (B, T, H, W, C)."""
    h = x
    for i in range(1, 5):
        s = f"{name}.conv{i}"
        h = F.silu(group_norm(P, s + ".0", h, 1e-5))
        wk = s + (".2" if i == 1 else ".3")
        w = lowered(P[wk + ".weight"])
        h = F.conv3d(lowered(h).permute(0, 4, 1, 2, 3), w, P[wk + ".bias"],
                     padding=(1, 0, 0)).permute(0, 2, 3, 4, 1)
    return x + h


def _res(P, name, x, emb, b):
    h = conv2d(P, name + ".in_layers.2", F.silu(group_norm(P, name + ".in_layers.0", x, 1e-5)))
    h = h + linear(P, name + ".emb_layers.1", F.silu(emb))[:, None, None, :]
    h = conv2d(P, name + ".out_layers.3",
               F.silu(group_norm(P, name + ".out_layers.0", h, 1e-5)))
    if name + ".skip_connection.weight" in P:
        x = conv2d(P, name + ".skip_connection", x)
    h = x + h
    n, hh, ww, c = h.shape
    v = _temporal_conv(P, name + ".temopral_conv", h.reshape(b, n // b, hh, ww, c))
    return v.reshape(n, hh, ww, c)


def _run_block(P, name, plan, h, emb, context, b, dh):
    for j, (lt, _) in enumerate(plan):
        m = f"{name}.{j}"
        if lt == "conv_in":
            h = conv2d(P, m, h)
        elif lt == "res":
            h = _res(P, m, h, emb, b)
        elif lt == "spatial":
            h = _spatial(P, m, h, context, dh)
        elif lt == "temporal":
            n, hh, ww, c = h.shape
            h = _temporal(P, m, h.reshape(b, n // b, hh, ww, c), dh).reshape(n, hh, ww, c)
        elif lt == "down":
            h = conv2d(P, m + ".op", h, stride=2, pad=(1, 1, 1, 1))
        else:
            h = conv2d(P, m + ".conv", h.repeat_interleave(2, 1).repeat_interleave(2, 2))
    return h


def unet(P, u: dict, x, t, context, label, fs):
    """The denoiser: x (B, T, h, w, in) noisy latents with the conditions
    concatenated, t (B,) timesteps, context (B, 77 + T * 16, D) text and
    per-frame image tokens, label (B,) task labels, fs (B,) frame rates ->
    v (B, T, h, w, out)."""
    b, nt, hh, ww, _ = x.shape
    mc, dh = u["model_channels"], u["num_head_channels"]
    P = {k[5:]: v for k, v in P.items() if k.startswith("unet.")}

    def mlp(name, v):
        return linear(P, name + ".2", F.silu(linear(P, name + ".0", v)))

    emb = mlp("time_embed", timestep_embedding(t, mc))
    emb = emb + mlp("class_embed", timestep_embedding(label, mc))
    tl, ipf = u["text_context_len"], u["image_tokens_per_frame"]
    ctx = torch.cat([context[:, :tl].repeat_interleave(nt, 0),
                     context[:, tl:].reshape(b * nt, ipf, -1)], dim=1)
    emb = emb.repeat_interleave(nt, 0)
    emb = emb + mlp("fps_embedding", timestep_embedding(fs, mc)).repeat_interleave(nt, 0)
    h = x.reshape(b * nt, hh, ww, x.shape[-1])
    inp, mid, out = unet_plan(u)
    hs = []
    for i, plan in enumerate(inp):
        h = _run_block(P, f"input_blocks.{i}", plan, h, emb, ctx, b, dh)
        if i == 0:
            n, h_, w_, c = h.shape
            h = _temporal_init(P, h.reshape(b, nt, h_, w_, c), dh).reshape(n, h_, w_, c)
        hs.append(h)
    h = _run_block(P, "middle_block", mid, h, emb, ctx, b, dh)
    for i, plan in enumerate(out):
        h = _run_block(P, f"output_blocks.{i}", plan, torch.cat([h, hs.pop()], -1), emb, ctx,
                       b, dh)
    h = conv2d(P, "out.2", F.silu(group_norm(P, "out.0", h, 1e-5)))
    return h.reshape(b, nt, hh, ww, -1)


def _temporal_init(P, x, dh):
    """The addition attention after the first block: a temporal
    transformer of 8 heads with 1x1-conv projections."""
    return _temporal(P, "init_attn.0", x, dh)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def _resnet(P, name, x):
    h = conv2d(P, name + ".conv1", F.silu(group_norm(P, name + ".norm1", x, 1e-6)))
    h = conv2d(P, name + ".conv2", F.silu(group_norm(P, name + ".norm2", h, 1e-6)))
    if name + ".nin_shortcut.weight" in P:
        x = conv2d(P, name + ".nin_shortcut", x)
    return x + h


def _attn_block(P, name, x):
    n, h, w, c = x.shape
    hn = group_norm(P, name + ".norm", x, 1e-6)
    q, k, v = (conv2d(P, f"{name}.{s}", hn).reshape(n, h * w, 1, c) for s in "qkv")
    return x + conv2d(P, name + ".proj_out", attention(q, k, v).reshape(n, h, w, c))


def _mid(P, name, h):
    h = _resnet(P, name + ".block_1", h)
    h = _attn_block(P, name + ".attn_1", h)
    return _resnet(P, name + ".block_2", h)


def vae_moments(P, v: dict, x):
    """Images (N, H, W, 3) -> the posterior's moments (N, H/f, W/f, 2z):
    mean | log variance."""
    h = conv2d(P, "vae.encoder.conv_in", x)
    for i in range(len(v["ch_mult"])):
        for j in range(v["num_res_blocks"]):
            h = _resnet(P, f"vae.encoder.down.{i}.block.{j}", h)
        if i != len(v["ch_mult"]) - 1:
            h = conv2d(P, f"vae.encoder.down.{i}.downsample.conv", h, stride=2, pad=(0, 1, 0, 1))
    h = _mid(P, "vae.encoder.mid", h)
    h = conv2d(P, "vae.encoder.conv_out", F.silu(group_norm(P, "vae.encoder.norm_out", h, 1e-6)))
    return conv2d(P, "vae.quant_conv", h)


def vae_encode(P, v: dict, x):
    """Images (N, H, W, 3) -> scaled latents (N, H/f, W/f, z): the
    posterior's mean times the scale factor."""
    moments = vae_moments(P, v, x)
    return v["scale_factor"] * moments[..., :moments.shape[-1] // 2]


def vae_post_quant(P, v: dict, z):
    """Scaled latents (N, h, w, z) -> the decoder's input (N, h, w, z)."""
    return conv2d(P, "vae.post_quant_conv", z / v["scale_factor"])


def vae_decoder(P, v: dict, h):
    """The decoder's input (N, h, w, z) -> images (N, fh, fw, 3), unclamped."""
    h = _mid(P, "vae.decoder.mid", conv2d(P, "vae.decoder.conv_in", h))
    for i in reversed(range(len(v["ch_mult"]))):
        for j in range(v["num_res_blocks"] + 1):
            h = _resnet(P, f"vae.decoder.up.{i}.block.{j}", h)
        if i != 0:
            h = conv2d(P, f"vae.decoder.up.{i}.upsample.conv",
                       h.repeat_interleave(2, 1).repeat_interleave(2, 2))
    return conv2d(P, "vae.decoder.conv_out",
                  F.silu(group_norm(P, "vae.decoder.norm_out", h, 1e-6)))


def vae_decode(P, v: dict, z):
    """Scaled latents (N, h, w, z) -> images (N, fh, fw, 3), unclamped."""
    return vae_decoder(P, v, vae_post_quant(P, v, z))


# ---------------------------------------------------------------------------
# CLIP towers and the resampler
# ---------------------------------------------------------------------------

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _clip_block(P, name, x, heads, causal):
    b, l, w = x.shape
    y = layer_norm(P, name + ".ln_1", x)
    qkv = F.linear(lowered(y), lowered(P[name + ".attn.in_proj_weight"]),
                   P[name + ".attn.in_proj_bias"])
    q, k, v = (t.reshape(b, l, heads, w // heads) for t in qkv.chunk(3, -1))
    x = x + linear(P, name + ".attn.out_proj", attention(q, k, v, causal).reshape(b, l, w))
    y = linear(P, name + ".mlp.c_fc", layer_norm(P, name + ".ln_2", x))
    return x + linear(P, name + ".mlp.c_proj", F.gelu(y))


def text_encode(P, t: dict, tokens):
    """Token ids (B, 77) -> (B, 77, width): the causal transformer stopped
    skip_last_layers blocks early, then ln_final (OpenCLIP 'penultimate')."""
    x = P["clip_text.token_embedding.weight"][tokens] + P["clip_text.positional_embedding"]
    for i in range(t["layers"] - t["skip_last_layers"]):
        x = _clip_block(P, f"clip_text.transformer.resblocks.{i}", x, t["heads"], True)
    return layer_norm(P, "clip_text.ln_final", x)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(n_in, n_out):
    """(n_in, n_out) antialiased bicubic resampling (Keys, a = -0.5; the
    kernel widened by n_in / n_out when downsampling, weights renormalised
    per output, outputs sampled outside the input zero)."""
    inv = n_in / n_out
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / max(inv, 1.0)
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def image_encode(P, v: dict, images):
    """Images (B, H, W, 3) in [-1, 1] -> every token of the ViT, (B, grid^2
    + 1, width): bicubic resize to image_size, CLIP normalisation, patch
    embedding, class token, ln_pre, the transformer (no ln_post)."""
    s = v["image_size"]
    h, w = images.shape[1:3]
    x = images
    if h != s:
        x = torch.einsum("bhwc,hH->bHwc", x, torch.as_tensor(resize_matrix(h, s), dtype=x.dtype,
                                                             device=x.device))
    if w != s:
        x = torch.einsum("bhwc,wW->bhWc", x, torch.as_tensor(resize_matrix(w, s), dtype=x.dtype,
                                                             device=x.device))
    x = (x + 1.0) / 2.0
    x = (x - torch.tensor(CLIP_MEAN, device=x.device)) / torch.tensor(CLIP_STD, device=x.device)
    ps, width = v["patch_size"], v["width"]
    x = conv2d(P, "clip_image.conv1", x, stride=ps, pad=(0, 0, 0, 0))
    b = x.shape[0]
    x = x.reshape(b, -1, width)
    cls = P["clip_image.class_embedding"].expand(b, 1, width)
    x = torch.cat([cls, x], dim=1) + P["clip_image.positional_embedding"]
    x = layer_norm(P, "clip_image.ln_pre", x)
    for i in range(v["layers"]):
        x = _clip_block(P, f"clip_image.transformer.resblocks.{i}", x, v["heads"], False)
    return x


def resample(P, r: dict, x):
    """The perceiver resampler: image tokens (B, L, embedding_dim) ->
    (B, num_queries * video_length, output_dim)."""
    dh, heads = r["dim_head"], r["heads"]
    lat = P["image_proj.latents"].expand(x.shape[0], -1, -1)
    x = linear(P, "image_proj.proj_in", x)
    for i in range(r["depth"]):
        n = f"image_proj.layers.{i}"
        xs = layer_norm(P, n + ".0.norm1", x)
        ls = layer_norm(P, n + ".0.norm2", lat)
        q = _heads(linear(P, n + ".0.to_q", ls), dh)
        k, v = (_heads(t, dh) for t in linear(P, n + ".0.to_kv",
                                             torch.cat([xs, ls], 1)).chunk(2, -1))
        scale = dh ** -0.25
        w = torch.einsum("bqhd,bkhd->bhqk", lowered(q * scale), lowered(k * scale)).softmax(-1)
        o = torch.einsum("bhqk,bkhd->bqhd", lowered(w), lowered(v)).reshape(*lat.shape[:2], -1)
        lat = linear(P, n + ".0.to_out", o) + lat
        ff = linear(P, n + ".1.1", layer_norm(P, n + ".1.0", lat))
        lat = linear(P, n + ".1.3", F.gelu(ff)) + lat
    return layer_norm(P, "image_proj.norm_out", linear(P, "image_proj.proj_out", lat))
