"""PyTorch port vs JAX for the UNet, the VAE and the whole MDM512 denoising
slice at the tiny config of bench.py:251-256, plus the weight conversion,
the MDM512 kernel dispatch sites and the port's freedom from JAX.

Every leaf of every parameter tree is randomized (test_torch_util.random_tree),
so the zero-initialised output projections carry signal. Tolerance of the
fp32 comparisons: tests/test_reference_oracle.py:50, 2e-3 * scale + 5e-5.
"""
from __future__ import annotations

import ast
import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudg_tpu.core import diffusion as JD
from mudg_tpu.diffusion import ddim as JDDIM
from mudg_tpu.models import mdm as JMDM
from mudg_tpu.nn import unet3d as JU
from mudg_tpu.nn import vae as JV
from mudg_tpu.train.checkpoint import jax_to_torch_layout
from mudg_tpu_torch import convert
from mudg_tpu_torch.models import mdm as TMDM
from mudg_tpu_torch.nn import unet3d as TU
from mudg_tpu_torch.nn import vae as TV
from test_torch_util import assert_close, count_kernel_calls, port, random_tree, t, to_jax

REPO = pathlib.Path(__file__).resolve().parent.parent

TINY_UNET = dict(in_channels=12, out_channels=4, model_channels=32, num_res_blocks=1,
                 attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=16,
                 context_dim=16, temporal_length=4, image_tokens_per_frame=16, dropout=0.0)
TINY_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
SLICE_TOL, SLICE_ATOL = 2e-3, 5e-5
B, T, H, W = 1, 4, 8, 8


@pytest.fixture(scope="module")
def trees():
    key = jax.random.PRNGKey(0)
    unet = random_tree(jax.eval_shape(lambda: JU.init_unet(key, JU.UNetConfig(**TINY_UNET))), 1)
    vae = random_tree(jax.eval_shape(lambda: JV.init_vae(key, JV.VAEConfig(**TINY_VAE))), 2)
    return unet, vae


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((2, T, H, W, 12)).astype(f32),
        ctx=rng.standard_normal((2, 77 + T * 16, 16)).astype(f32),
        x_T=rng.standard_normal((B, T, H, W, 4)).astype(f32),
        c_concat=(rng.standard_normal((B, T, H, W, 8)) * 0.5).astype(f32),
        ctx_c=rng.standard_normal((B, 77 + T * 16, 16)).astype(f32),
        ctx_u=rng.standard_normal((B, 77 + T * 16, 16)).astype(f32),
        z=rng.standard_normal((B, T, H, W, 4)).astype(f32),
    )


def test_unet_forward_matches_jax(trees, inputs):
    unet_tree, _ = trees
    ts = np.array([999, 421], np.int64)
    lab = np.array([0, 500], np.int64)
    fs = np.array([10, 3], np.int64)
    ref = JU.unet_apply(to_jax(unet_tree), JU.UNetConfig(**TINY_UNET), jnp.asarray(inputs["x"]),
                        jnp.asarray(ts, jnp.int32), jnp.asarray(inputs["ctx"]),
                        c_label=jnp.asarray(lab, jnp.int32), fs=jnp.asarray(fs, jnp.int32))
    unet = port(TU.UNet3D(TU.UNetConfig(**TINY_UNET)), unet_tree)
    with torch.no_grad():
        ours = unet(t(inputs["x"]), t(ts), t(inputs["ctx"]), c_label=t(lab), fs=t(fs))
    assert_close(ours, ref, SLICE_TOL, SLICE_ATOL, "unet")


def test_vae_decode_video_matches_jax(trees, inputs):
    _, vae_tree = trees
    ref = JV.decode_video(to_jax(vae_tree), JV.VAEConfig(**TINY_VAE), jnp.asarray(inputs["z"]),
                          chunk=2)
    vae = port(TV.AutoencoderKL(TV.VAEConfig(**TINY_VAE)), vae_tree)
    with torch.no_grad():
        ours = TV.decode_video(vae, t(inputs["z"]), chunk=2)
    assert ours.shape == (B, T, 2 * H, 2 * W, 3)
    assert_close(ours, ref, SLICE_TOL, SLICE_ATOL, "decode")


def test_vae_encode_matches_jax(trees):
    _, vae_tree = trees
    x = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    ref = JV.encode(to_jax(vae_tree), JV.VAEConfig(**TINY_VAE), jnp.asarray(x))
    vae = port(TV.AutoencoderKL(TV.VAEConfig(**TINY_VAE)), vae_tree)
    with torch.no_grad():
        ours = vae.encode(t(x))
    assert_close(ours, ref, SLICE_TOL, SLICE_ATOL, "encode")


def test_slice_matches_jax_composition(trees, inputs):
    """3 DDIM steps (eta 0, given x_T) with 2-point CFG + rescale, then the
    decode, against the same composition of JAX functions (bench.py:115-133)."""
    unet_tree, vae_tree = trees
    ucfg, vcfg = JU.UNetConfig(**TINY_UNET), JV.VAEConfig(**TINY_VAE)
    steps, guidance, rescale = 3, 7.5, 0.7
    consts = JDDIM.make_ddim_constants(JMDM.MDMConfig().schedule(), steps,
                                       timestep_spacing="uniform_trailing", eta=0.0)
    junet, jvae = to_jax(unet_tree), to_jax(vae_tree)
    ctx_all = jnp.concatenate([jnp.asarray(inputs["ctx_u"]), jnp.asarray(inputs["ctx_c"])])
    cc_all = jnp.tile(jnp.asarray(inputs["c_concat"]), (2, 1, 1, 1, 1))
    labels = jnp.zeros((2,), jnp.int32)
    fs = jnp.full((2,), 10, jnp.int32)

    def model_fn(x, tstep):
        xin = jnp.concatenate([jnp.tile(x, (2, 1, 1, 1, 1)), cc_all], axis=-1)
        v = JU.unet_apply(junet, ucfg, xin, jnp.tile(tstep, (2,)), ctx_all, c_label=labels, fs=fs)
        e_uc, e_c = jnp.split(v, 2, axis=0)
        return JD.rescale_noise_cfg(JD.cfg_combine(e_uc, e_c, guidance), e_c, rescale)

    z = JDDIM.ddim_sample(model_fn, jax.random.PRNGKey(1), inputs["x_T"].shape, consts,
                          x_T=jnp.asarray(inputs["x_T"]))
    ref = jnp.clip(JV.decode_video(jvae, vcfg, z, chunk=4), -1, 1)

    cfg = TMDM.MDMConfig(unet=TU.UNetConfig(**TINY_UNET), vae=TV.VAEConfig(**TINY_VAE))
    with torch.device("meta"):   # sample_clip takes the context: no CLIP, no resampler
        mdm = TMDM.MDM(cfg)
    mdm.unet = port(TU.UNet3D(cfg.unet), unet_tree)
    mdm.vae = port(TV.AutoencoderKL(cfg.vae), vae_tree)
    ours = TMDM.sample_clip(mdm, t(inputs["c_concat"]), t(inputs["ctx_c"]), t(inputs["ctx_u"]),
                            torch.zeros(1, dtype=torch.int64),
                            generator=torch.Generator().manual_seed(0), num_steps=steps,
                            guidance_scale=guidance, guidance_rescale=rescale, eta=0.0,
                            x_T=t(inputs["x_T"]), decode_chunk=4)
    assert ours.shape == (B, T, 2 * H, 2 * W, 3) and ours.dtype == torch.float32
    assert float(np.abs(np.asarray(ref)).max()) > 0.05   # the clip carries signal
    assert_close(ours, ref, SLICE_TOL, SLICE_ATOL, "slice")


def test_convert_strict_load(trees):
    unet_tree, _ = trees
    sd = convert.tree_to_state_dict(unet_tree)
    module = TU.UNet3D(TU.UNetConfig(**TINY_UNET))
    assert set(sd) == set(module.state_dict())
    assert any("temopral_conv" in k for k in sd)
    w = unet_tree["input_blocks"]["1"]["1"]["proj_in"]["weight"]          # (in, out)
    port(module, unet_tree)
    np.testing.assert_array_equal(
        module.input_blocks["1"]["1"].proj_in.weight.detach().numpy(), w.T)
    broken = dict(unet_tree)
    del broken["time_embed"]
    with pytest.raises(RuntimeError, match="Missing key"):
        convert.load_tree(TU.UNet3D(TU.UNetConfig(**TINY_UNET)), broken)


def _torch_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_torch_shapes(v, key + "."))
        else:
            stub = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), v.shape,
                                                   (0,) * len(v.shape))
            out[key] = tuple(jax_to_torch_layout(key, stub).shape)
    return out


def test_full_size_trees_match_meta_modules():
    """The 1.44B UNet and the full VAE: every JAX leaf (jax.eval_shape) has
    a port parameter of the torch-layout shape, and nothing else exists."""
    key = jax.random.PRNGKey(0)
    for init, module in ((lambda: JU.init_unet(key, JU.UNetConfig()),
                          lambda: TU.UNet3D(TU.UNetConfig())),
                         (lambda: JV.init_vae(key, JV.VAEConfig()),
                          lambda: TV.AutoencoderKL(TV.VAEConfig()))):
        want = _torch_shapes(jax.eval_shape(init))
        with torch.device("meta"):
            got = {k: tuple(v.shape) for k, v in module().state_dict().items()}
        assert got == want
    assert sum(math.prod(s) for s in _torch_shapes(jax.eval_shape(
        lambda: JU.init_unet(key, JU.UNetConfig()))).values()) == 1_440_917_060


def test_mdm512_dispatch_sites(monkeypatch):
    """One full-width MDM512 UNet forward (batch 2, 16 frames, 40x64, bf16),
    traced on the meta device, reaches the kernel wrappers at exactly the
    JAX dispatch's sites: 10 spatial, 11 temporal, 33 FF, 20 tconv, and no
    flash attention (no self-attention there has L >= 512 outside kernel 1);
    the plain path at none; in fp32 kernels 1-4 (bf16 only) at none, so the
    10 spatial self-attentions (L = 2560, 640) reach kernel 5 in fp32, as the
    JAX dispatch sends them to its flash kernel."""
    calls = count_kernel_calls(monkeypatch)
    bf = torch.bfloat16
    with torch.device("meta"):
        unet = TU.UNet3D(TU.UNetConfig()).to(bf)
        x = torch.empty(2, 16, 40, 64, 12, dtype=bf)
        ctx = torch.empty(2, 77 + 256, 1024, dtype=bf)
        ts = torch.zeros(2, dtype=torch.int64)
        with torch.no_grad():
            y = unet(x, ts, ctx, c_label=ts)
            assert y.shape == (2, 16, 40, 64, 4)
            assert calls == {"spatial_attn": 10, "temporal_attn": 11, "geglu_ff": 33,
                             "gn_silu_tconv": 20, "flash_attention": 0}
            for k in calls:
                calls[k] = 0
            unet(x, ts, ctx, c_label=ts, impl="plain")
            assert sum(calls.values()) == 0
            unet.float()(x.float(), ts, ctx.float(), c_label=ts)   # fp32: kernel 5 only
            assert calls == {"spatial_attn": 0, "temporal_attn": 0, "geglu_ff": 0,
                             "gn_silu_tconv": 0, "flash_attention": 10}


def test_port_imports_no_jax():
    """Importing every module of the port and converting a tree (the call
    that loads weights) loads neither JAX nor the JAX package."""
    code = (
        "import sys, numpy as np, mudg_tpu_torch, mudg_tpu_torch.convert, "
        "mudg_tpu_torch.kernels, mudg_tpu_torch.models.mdm, mudg_tpu_torch.models.presets, "
        "mudg_tpu_torch.nn.unet3d, mudg_tpu_torch.nn.vae, mudg_tpu_torch.nn.resampler, "
        "mudg_tpu_torch.conditioning.clip, mudg_tpu_torch.diffusion.dpm, "
        "mudg_tpu_torch.gs.train, mudg_tpu_torch.gs.io, mudg_tpu_torch.apps.refine_gs, "
        "mudg_tpu_torch.__main__, mudg_tpu_torch.render.pointcloud, "
        "mudg_tpu_torch.utils.media, mudg_tpu_torch.apps.render_infer, "
        "mudg_tpu_torch.apps.serve, mudg_tpu_torch.train.checkpoint, "
        "mudg_tpu_torch.conditioning.tokenizer, mudg_tpu_torch.data.waymo, "
        "mudg_tpu_torch.data.conditions, mudg_tpu_torch.parallel.mesh, "
        "mudg_tpu_torch.parallel.sp, mudg_tpu_torch.parallel.tp, mudg_tpu_torch.train.step, "
        "mudg_tpu_torch.apps.train_mdm, mudg_tpu_torch.quant, mudg_tpu_torch.apps.quantize_ckpt, "
        "mudg_tpu_torch.apps.make_conditions, mudg_tpu_torch.render.splat, "
        "mudg_tpu_torch.utils.native, mudg_tpu_torch.data.waymo_proto, "
        "mudg_tpu_torch.data.waymo_etl, mudg_tpu_torch.apps.preprocess, "
        "mudg_tpu_torch.data.scene, mudg_tpu_torch.render.lidar, "
        "mudg_tpu_torch.apps.build_clouds, mudg_tpu_torch.data.video\n"
        "tree = {'a': {'weight': np.ones((2, 3), np.float32)},"
        " 'token_embedding': {'weight': np.ones((4, 2), np.float32)}}\n"
        "sd = mudg_tpu_torch.convert.tree_to_state_dict(tree)\n"
        "assert tuple(sd['a.weight'].shape) == (3, 2), sd\n"
        "assert tuple(sd['token_embedding.weight'].shape) == (4, 2), sd\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'mudg_tpu.')) or m == 'mudg_tpu']\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def _imported_modules(path):
    """Every module an `import` or `from ... import` in the file names, at
    any depth (lazy imports inside functions included); relative imports are
    resolved against the file's package."""
    rel = path.relative_to(REPO).with_suffix("")
    package = list(rel.parts[:-1])
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names += [mod] + [f"{mod}.{a.name}" for a in node.names]
    return names


def test_port_sources_import_no_jax():
    """An ast scan of every .py file of the port and of chip_smoke.py: no
    import of jax or of the JAX package, lazy or not."""
    files = sorted((REPO / "mudg_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {str(f.relative_to(REPO)) for f in files}
    assert {f"mudg_tpu_torch/{m}.py" for m in (
        "apps/render_infer", "apps/serve", "train/checkpoint", "conditioning/tokenizer",
        "data/waymo", "data/conditions", "utils/media", "parallel/mesh", "parallel/sp",
        "parallel/tp", "quant", "apps/quantize_ckpt", "apps/make_conditions",
        "render/splat", "utils/native", "data/waymo_proto", "data/waymo_etl",
        "apps/preprocess", "data/scene", "render/lidar", "apps/build_clouds",
        "data/video")} <= scanned
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "mudg_tpu")]
    assert not bad, bad
    # the scan resolves relative imports: the port's own modules are seen
    assert "mudg_tpu_torch.nn.functional" in _imported_modules(
        REPO / "mudg_tpu_torch" / "nn" / "attention.py")
