"""The port's SD2 UNet2D and DepthLab against the JAX package, on the CPU.

- `tests/test_depthlab.py`'s TINY UNet with random weights in plain, write
  and read modes against `sd_unet2d.apply`: outputs and every bank entry.
- The diffusers UNet keys: the full-width SD2 modules carry exactly JAX's
  `init` leaves under diffusers' names; a diffusers-named AutoencoderKL
  state dict renamed into `nn/vae.AutoencoderKL` equals JAX's import.
- `predict_depth` at 2-3 DDIM steps, eps and v prediction, with JAX's noise
  draws injected, against JAX's `predict_depth`.
- `load_depthlab_dir` against JAX's, and `densify_scene` against JAX's app:
  the classical path bit for bit, the DepthLab path within tolerance.
- Dispatch: a full-width DepthLab write and read pass on the meta device
  (fp32 and bf16) calls kernels 5 and 3 exactly where `jax.eval_shape` of
  the JAX UNet calls its Pallas kernels (chip_smoke.py's DEPTHLAB_SITES),
  and under MUDG_FUSED_NORMS=1 MUDG_SHORT_ATTN=1 every kernel-11/12 shape
  of those passes and of SegFormer-B3 is in chip_smoke.py's phase-11 tables.
"""
from __future__ import annotations

import collections
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
import mudg_tpu.kernels.flash_attention as JFA
import mudg_tpu.kernels.mlp as JM
from mudg_tpu.apps import densify_depth as JAPP
from mudg_tpu.models import depthlab as JDL
from mudg_tpu.models import sd_unet2d as JU
from mudg_tpu.nn import vae as JVAE
from mudg_tpu.train import checkpoint as JCKPT
from mudg_tpu_torch import convert
from mudg_tpu_torch.apps import densify_depth as TAPP
from mudg_tpu_torch.models import depthlab as TDL
from mudg_tpu_torch.models import sd_unet2d as TU
from mudg_tpu_torch.nn import vae as TVAE
from test_torch_util import assert_close, count_kernel_calls, port, random_tree, t

TOL = 1e-4   # tests/test_reference_oracle.py:46-53's fp32 tolerance
ATOL = 1e-5

TINY = dict(out_channels=4, block_out_channels=(16, 32), layers_per_block=1,
            cross_attention_dim=24, head_dim=8, norm_num_groups=4)
TINY_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)


def _unet_cfgs(in_channels):
    return (JU.SDUNetConfig(in_channels=in_channels, **TINY),
            TU.SDUNetConfig(in_channels=in_channels, **TINY))


def _dl_cfgs(prediction_type="eps"):
    j = JDL.DepthLabConfig(unet=_unet_cfgs(12)[0], ref_unet=_unet_cfgs(4)[0],
                           vae=JVAE.VAEConfig(**TINY_VAE), image_embed_dim=20,
                           prediction_type=prediction_type)
    p = TDL.DepthLabConfig(unet=_unet_cfgs(12)[1], ref_unet=_unet_cfgs(4)[1],
                           vae=TVAE.VAEConfig(**TINY_VAE), image_embed_dim=20,
                           prediction_type=prediction_type)
    return j, p


def _unet_pair(in_channels, seed):
    jcfg, tcfg = _unet_cfgs(in_channels)
    tree = random_tree(jax.eval_shape(lambda: JU.init(jax.random.PRNGKey(0), jcfg)), seed)
    return jcfg, tree, port(TU.UNet2DConditionModel(tcfg), tree)


def test_tiny_unet_plain_write_read_match_jax():
    jcfg, tree, unet = _unet_pair(4, 10)
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(11)
    # the shapes of predict_depth's passes below (JAX compiles each op once)
    x = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    x2 = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 1, 24)).astype(np.float32)
    ts = np.array([500], np.int32)
    with torch.no_grad():
        ours = unet(t(x), t(ts).long(), t(ctx))
        ours_w, bank = unet(t(x), t(ts).long(), t(ctx), ref_mode="write")
        ours_r = unet(t(x2), t(ts).long(), t(ctx), ref_mode="read", ref_bank=bank)
    ref = JU.apply(jp, jcfg, x, ts, ctx)
    ref_w, jbank = JU.apply(jp, jcfg, x, ts, ctx, ref_mode="write")
    ref_r = JU.apply(jp, jcfg, x2, ts, ctx, ref_mode="read", ref_bank=jbank)
    assert_close(ours, np.asarray(ref), TOL, ATOL, "plain")
    assert_close(ours_w, np.asarray(ref_w), TOL, ATOL, "write")
    # down 1 + mid 1 + up 2 transformer blocks, in traversal order
    assert len(bank) == len(jbank) == 4
    for i, (a, b) in enumerate(zip(bank, jbank)):
        assert_close(a, np.asarray(b), TOL, ATOL, f"bank {i}")
    assert_close(ours_r, np.asarray(ref_r), TOL, ATOL, "read")
    assert float((ours_r - ours).abs().max()) > 1e-3   # the bank changed the read pass


def test_sd2_modules_carry_the_diffusers_keys_of_jax_init():
    cfg = JU.SDUNetConfig(in_channels=12)
    shapes = jax.eval_shape(lambda: JU.init(jax.random.PRNGKey(0), cfg))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    theirs = {k: tuple(v.shape) for k, v in convert.pytree_to_state_dict(zeros).items()}
    with torch.device("meta"):
        unet = TU.UNet2DConditionModel(TU.SDUNetConfig(in_channels=12))
    ours = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    assert ours == theirs
    for key in ("conv_in.weight", "time_embedding.linear_1.weight",
                "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
                "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight",
                "mid_block.attentions.0.proj_out.weight", "up_blocks.0.upsamplers.0.conv.weight",
                "up_blocks.3.attentions.2.transformer_blocks.0.attn2.to_k.weight"):
        assert key in ours, key
    assert 860e6 < sum(np.prod(s) for s in ours.values()) < 870e6


def _compvis_to_diffusers(key: str, num_levels: int) -> str:
    """The test-side inverse of the import renaming (tests/test_depthlab.py)."""
    k = key
    k = k.replace("norm_out", "conv_norm_out")
    k = k.replace("mid.block_1", "mid_block.resnets.0")
    k = k.replace("mid.block_2", "mid_block.resnets.1")
    k = k.replace("mid.attn_1", "mid_block.attentions.0")
    if ".attentions.0." in k:
        k = k.replace(".norm.", ".group_norm.")
        k = k.replace(".q.", ".to_q.").replace(".k.", ".to_k.").replace(".v.", ".to_v.")
        k = k.replace(".proj_out.", ".to_out.0.")
    k = k.replace(".nin_shortcut.", ".conv_shortcut.")
    if ".down." in k:
        k = k.replace(".down.", ".down_blocks.").replace(".block.", ".resnets.")
        k = k.replace(".downsample.conv.", ".downsamplers.0.conv.")
    if ".up." in k:
        parts = k.split(".")
        i = parts.index("up")
        parts[i] = "up_blocks"
        parts[i + 1] = str(num_levels - 1 - int(parts[i + 1]))
        k = ".".join(parts).replace(".block.", ".resnets.")
        k = k.replace(".upsample.conv.", ".upsamplers.0.conv.")
    return k


def _diffusers_vae(vae_tree, num_levels):
    out = {}
    for key, val in JCKPT.pytree_to_state_dict(vae_tree).items():
        new = _compvis_to_diffusers(key, num_levels)
        val = np.asarray(val, np.float32)
        if ".attentions.0.to_" in new and new.endswith("weight") and val.ndim == 4:
            val = val.reshape(val.shape[:2])
        out[new] = val
    return out


def _vae_tree(seed):
    cfg = JVAE.VAEConfig(**TINY_VAE)
    return random_tree(jax.eval_shape(lambda: JVAE.init_vae(jax.random.PRNGKey(0), cfg)), seed)


def test_diffusers_vae_import_matches_jax():
    tree = _vae_tree(20)
    diff = _diffusers_vae(tree, 2)
    ours = TDL.diffusers_vae_state_dict(diff, num_levels=2)
    theirs = convert.tree_to_state_dict(JDL.diffusers_vae_to_pytree(diff, num_levels=2))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), err_msg=k)
    vae = TVAE.AutoencoderKL(TVAE.VAEConfig(**TINY_VAE))
    vae.load_state_dict(ours, strict=True)
    x = np.random.default_rng(21).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    ref = JVAE.encode_moments(jax.tree.map(jnp.asarray, tree), JVAE.VAEConfig(**TINY_VAE),
                              jnp.asarray(x)).mode()
    with torch.no_grad():
        assert_close(vae.encode_moments(t(x))[..., :4], np.asarray(ref), TOL, ATOL, "moments")


def _depthlab(prediction_type="eps", seed=30):
    jcfg, tcfg = _dl_cfgs(prediction_type)
    tree = random_tree(jax.eval_shape(lambda: JDL.init(jax.random.PRNGKey(0), jcfg)), seed)
    vae_tree = _vae_tree(seed + 1)
    model = port(TDL.DepthLab(tcfg), tree)
    vae = port(TVAE.AutoencoderKL(tcfg.vae), vae_tree)
    return jcfg, tcfg, tree, vae_tree, model, vae


def _jax_draws(shape, steps, strength, rng=None):
    """The start noise and the per-step blend noise JAX's `_ddim_depth_loop`
    draws from `rng` (PRNGKey(0) by default), as torch tensors."""
    rng = jax.random.PRNGKey(0) if rng is None else rng
    n_run = max(1, min(steps, int(round(steps * strength))))
    rng, k0 = jax.random.split(rng)
    noise0 = jax.random.normal(k0, shape, jnp.float32)
    per_step = []
    for _ in range(n_run):
        rng, kq = jax.random.split(rng)
        per_step.append(t(np.asarray(jax.random.normal(kq, shape, jnp.float32))))
    return t(np.asarray(noise0)), per_step


def _sparse_scene(seed, hw=(32, 32), frac=0.15):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 255, (*hw, 3)).astype(np.float32)
    sparse = np.where(rng.uniform(size=hw) < frac, rng.uniform(2.0, 50.0, hw), 0.0)
    return image, sparse.astype(np.float32)


@pytest.mark.parametrize("prediction_type,steps,blend", [("eps", 3, True), ("v", 2, True),
                                                         ("eps", 2, False)])
def test_predict_depth_matches_jax(prediction_type, steps, blend):
    jcfg, tcfg, tree, vae_tree, model, vae = _depthlab(prediction_type)
    image, sparse = _sparse_scene(40)
    ref = JDL.predict_depth(jax.tree.map(jnp.asarray, tree), jcfg,
                            jax.tree.map(jnp.asarray, vae_tree), image, sparse, steps=steps,
                            blend=blend)
    noise = _jax_draws((1, 16, 16, 4), steps, 0.8)
    ours = TDL.predict_depth(model, tcfg, vae, image, sparse, steps=steps, blend=blend,
                             noise=noise)
    assert ours.dtype == ref.dtype and ours.shape == (32, 32)
    assert_close(ours, ref, TOL, ATOL, "depth")
    # the draws matter: the port's own generator gives another prediction
    other = TDL.predict_depth(model, tcfg, vae, image, sparse, steps=steps, blend=blend)
    assert np.abs(other - ours).max() > 1e-4
    again = TDL.predict_depth(model, tcfg, vae, image, sparse, steps=steps, blend=blend)
    np.testing.assert_array_equal(other, again)


def test_mapping_layer_matches_jax():
    jcfg, tcfg, tree, _, model, _ = _depthlab()
    emb = np.random.default_rng(50).standard_normal((2, 20)).astype(np.float32)
    ref = JDL.mapping_apply(jax.tree.map(jnp.asarray, tree)["mapping_layer"], emb)
    with torch.no_grad():
        assert_close(TDL.mapping_apply(model.mapping_layer, t(emb)), np.asarray(ref), TOL, ATOL)


def _write_ckpt_dir(root, tree, vae_tree, vae_fmt):
    for name in ("denoising_unet", "reference_unet"):
        torch.save({k: t(np.asarray(v)) for k, v in
                    JCKPT.pytree_to_state_dict(tree[name]).items()}, root / f"{name}.pth")
    torch.save({f"proj.{k}": t(np.asarray(v)) for k, v in
                JCKPT.pytree_to_state_dict(tree["mapping_layer"]).items()},
               root / "mapping_layer.pth")
    (root / "vae").mkdir()
    diff = _diffusers_vae(vae_tree, 2)
    if vae_fmt == "bin":
        torch.save({k: t(v) for k, v in diff.items()}, root / "vae" / "diffusion_pytorch_model.bin")
    else:
        from test_torch_segformer import _write_safetensors

        _write_safetensors(root / "vae" / "diffusion_pytorch_model.safetensors", diff)


@pytest.mark.parametrize("vae_fmt", ["bin", "safetensors"])
def test_load_depthlab_dir_matches_jax(tmp_path, vae_fmt):
    jcfg, tcfg, tree, vae_tree, _, _ = _depthlab(seed=60)
    _write_ckpt_dir(tmp_path, tree, vae_tree, vae_fmt)
    model, cfg, vae = TDL.load_depthlab_dir(str(tmp_path), cfg=tcfg, device="cpu")
    params, _, vae_params = JDL.load_depthlab_dir(str(tmp_path), cfg=jcfg)
    assert cfg is tcfg
    for ours, theirs in ((model, params), (vae, vae_params)):
        ref = convert.tree_to_state_dict(theirs)
        sd = ours.state_dict()
        assert sorted(sd) == sorted(ref)
        for k in sd:
            np.testing.assert_array_equal(sd[k].numpy(), ref[k].numpy(), err_msg=k)
    # no VAE in the directory: None, as in JAX
    for f in (tmp_path / "vae").iterdir():
        f.unlink()
    assert TDL.load_depthlab_dir(str(tmp_path), cfg=tcfg, device="cpu")[2] is None


def _app_scene(root, hw=(32, 32)):
    import cv2

    from mudg_tpu.data.segmentation import write_pfm

    cam = "camera_FRONT"
    for d in (f"images/{cam}", f"six_frames_depth/{cam}", f"semantic/{cam}/seg"):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(70)
    for i in range(2):
        stem = f"{i:08d}"
        cv2.imwrite(str(root / "images" / cam / f"{stem}.jpg"),
                    rng.integers(0, 255, (*hw, 3), dtype=np.uint8))
        sparse = np.where(rng.uniform(size=hw) < 0.2, rng.uniform(2, 60, hw), 0)
        np.save(root / "six_frames_depth" / cam / f"{stem}.npy", sparse.astype(np.float32))
        sem = np.zeros(hw, np.float32)
        sem[:4] = 10.0
        write_pfm(str(root / "semantic" / cam / "seg" / f"{stem}.pfm"), sem)
    return cam


def _outputs(scene, cam):
    out = {}
    for sub in ("dense", "aligned", "processed", "vis"):
        d = os.path.join(scene, f"six_frames_depth_{sub}", cam)
        for f in sorted(os.listdir(d)):
            p = os.path.join(d, f)
            out[f"{sub}/{f}"] = np.load(p) if f.endswith(".npy") else open(p, "rb").read()
    return out


@pytest.mark.parametrize("no_cv2", [False, True])
def test_densify_scene_classical_bit_for_bit(tmp_path, monkeypatch, no_cv2):
    """The classical path (OpenCV's filters, or numpy's where OpenCV is
    absent) writes the same files as JAX's app, bit for bit."""
    outs = {}
    for name, app in (("ours", TAPP), ("theirs", JAPP)):
        scene = tmp_path / name
        cam = _app_scene(scene)
        with monkeypatch.context() as mp:
            if no_cv2:   # densify_classical's own import fails; the readers keep OpenCV
                import builtins

                real = builtins.__import__

                def imp(n, *a, **k):
                    if n == "cv2" and a and a[0] and a[0].get("__name__", "").endswith(
                            "depth_tools"):
                        raise ImportError(n)
                    return real(n, *a, **k)

                mp.setattr(builtins, "__import__", imp)
            assert app.densify_scene(str(scene), cameras=(cam,)) == 2
        outs[name] = _outputs(str(scene), cam)
    assert sorted(outs["ours"]) == sorted(outs["theirs"]) and len(outs["ours"]) == 14
    for k, v in outs["theirs"].items():
        if isinstance(v, bytes):
            assert outs["ours"][k] == v, k
        else:
            assert outs["ours"][k].dtype == v.dtype
            np.testing.assert_array_equal(outs["ours"][k], v, err_msg=k)
    proc = outs["ours"]["processed/00000000.npy"]
    assert (proc[:4] == 100.0).all()


def test_densify_scene_depthlab_matches_jax(tmp_path):
    """The DepthLab path of the app at 2 steps, the port's predictor given
    JAX's draws: the dense, aligned and processed maps within tolerance."""
    jcfg, tcfg, tree, vae_tree, model, vae = _depthlab(seed=80)
    jpred = JDL.DepthLabPredictor(jax.tree.map(jnp.asarray, tree), jcfg,
                                  jax.tree.map(jnp.asarray, vae_tree), steps=2)
    noise = _jax_draws((1, 16, 16, 4), 2, 0.8)
    tpred = TDL.DepthLabPredictor(model, tcfg, vae, steps=2)

    def ours(sparse, image=None):
        return TDL.predict_depth(tpred.model, tcfg, tpred.vae, image, sparse, steps=2,
                                 noise=noise)

    outs = {}
    for name, app, pred in (("ours", TAPP, ours), ("theirs", JAPP, jpred)):
        scene = tmp_path / name
        cam = _app_scene(scene)
        assert app.densify_scene(str(scene), cameras=(cam,), predictor=pred) == 2
        outs[name] = _outputs(str(scene), cam)
    for k, v in outs["theirs"].items():
        if not isinstance(v, bytes):
            assert_close(outs["ours"][k], v, TOL, ATOL, k)


# ---------------------------------------------------------------------------
# kernel dispatch at full width (meta device / jax.eval_shape)
# ---------------------------------------------------------------------------

FULL_LATENT = (160, 240)   # a 1280x1920 Waymo FRONT frame at f = 8
JAX_KERNELS = ((JFA, "flash_attention", "flash_attention"),
               (JM, "fused_geglu_ff", "geglu_ff"), (JM, "fused_geglu_ff_block", "geglu_ff"))


def _jax_passes(monkeypatch, dtype):
    """JAX kernel calls in `jax.eval_shape` of the full-width reference
    UNet's write pass and the denoising UNet's read pass (batch 1)."""
    calls = {"write": collections.Counter(), "read": collections.Counter()}
    phase = ["write"]
    for mod, fn, name in JAX_KERNELS:
        def fake(*a, _name=name, **k):
            calls[phase[0]][_name] += 1
            return a[0]
        monkeypatch.setattr(mod, fn, fake)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cfg = JDL.DepthLabConfig()
    params = jax.eval_shape(lambda: JDL.init(jax.random.PRNGKey(0), cfg))
    S = jax.ShapeDtypeStruct
    h, w = FULL_LATENT
    ctx = S((1, 1, 1024), dtype)
    _, bank = jax.eval_shape(
        lambda p, x, ts, c: JU.apply(p, cfg.ref_unet, x, ts, c, ref_mode="write"),
        params["reference_unet"], S((1, h, w, 4), dtype), S((1,), jnp.int32), ctx)
    phase[0] = "read"
    jax.eval_shape(lambda p, x, ts, c, b: JU.apply(p, cfg.unet, x, ts, c, ref_mode="read",
                                                   ref_bank=b),
                   params["denoising_unet"], S((1, h, w, 12), dtype), S((1,), jnp.int32), ctx,
                   bank)
    return {p: dict(c) for p, c in calls.items()}


def _port_passes(monkeypatch, dtype):
    calls = count_kernel_calls(monkeypatch)
    out = {}
    h, w = FULL_LATENT
    with torch.device("meta"), torch.no_grad():
        model = TDL.DepthLab(TDL.DepthLabConfig()).to(dtype)
        ctx = torch.empty(1, 1, 1024, dtype=dtype)
        ts = torch.zeros(1, dtype=torch.int64)
        _, bank = model.reference_unet(torch.empty(1, h, w, 4, dtype=dtype), ts, ctx,
                                       ref_mode="write")
        out["write"] = {k: v for k, v in calls.items() if v}
        for k in calls:
            calls[k] = 0
        y = model.denoising_unet(torch.empty(1, h, w, 12, dtype=dtype), ts, ctx,
                                 ref_mode="read", ref_bank=bank)
        out["read"] = {k: v for k, v in calls.items() if v}
    assert len(bank) == 16 and y.shape == (1, h, w, 4)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_depthlab_kernel_sites_match_jax_trace(monkeypatch, dtype):
    for var in CS.OPT_OUT + CS.SWITCH_VARS:
        monkeypatch.delenv(var, raising=False)
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    with monkeypatch.context() as mp:
        theirs = _jax_passes(mp, jd)
    ours = _port_passes(monkeypatch, td)
    assert ours == theirs == CS.DEPTHLAB_SITES[dtype]
    assert ours["write"]["flash_attention"] == 10 and "flash_attention" not in ours["read"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_switch_path_shapes_in_phase11_tables(monkeypatch, dtype):
    """With both switches, every GN, LN and short-KV call the JAX predicates
    admit in the full-width write and read passes (and, in fp32, in
    SegFormer-B3 on a 1280x1920 frame) goes to the kernel-11/12 wrappers, at
    a shape chip_smoke.py's phase 11 checks."""
    from mudg_tpu_torch.models import segformer as TS
    from test_torch_norms_short import Sites, assert_phase11_covers

    sites = Sites(monkeypatch)
    h, w = FULL_LATENT
    with torch.device("meta"), torch.no_grad():
        model = TDL.DepthLab(TDL.DepthLabConfig()).to(dtype)
        ctx = torch.empty(1, 1, 1024, dtype=dtype)
        ts = torch.zeros(1, dtype=torch.int64)
        _, bank = model.reference_unet(torch.empty(1, h, w, 4, dtype=dtype), ts, ctx,
                                       ref_mode="write")
        model.denoising_unet(torch.empty(1, h, w, 12, dtype=dtype), ts, ctx, ref_mode="read",
                             ref_bank=bank)
        if dtype == torch.float32:
            seg = TS.SegFormer(TS.SegFormerConfig())
            seg(torch.empty(1, 1280, 1920, 3))
    assert sites.counts() == sites.expect()
    assert sites.counts()["layer_norm"] > 0 and sites.counts()["short_kv_attention"] > 0
    assert_phase11_covers(sites)
