"""The port's training app and its feeders against the JAX package's, on the
CPU: the Waymo dataset (pixel and moments forms, all four tasks), the batch
loader, the item lists, the latent caches, the stage recipe, and the
`train` app end to end at the tiny preset (32x64, 4 frames).

Dataset and loader outputs are compared bit for bit (the same numpy code on
the same files); `precompute`'s bf16 moments against the JAX `precompute`
on the same (converted) VAE weights in fp32, within 1.5x the JAX bf16
`precompute`'s relative L2 error + 5e-3 (chip_smoke.py's gate for a bf16
path against fp32). The app runs are the port's alone, checked by their files, their
records and what loads from them; the `.ckpt` import with surgery is held
to JAX `load_mudg_checkpoint` bit for bit.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from mudg_tpu.data import latents as JL
from mudg_tpu.data import waymo as JW
from mudg_tpu.models import mdm as JMDM
from mudg_tpu.models import presets as JP
from mudg_tpu.nn import unet3d as JU
from mudg_tpu.train import checkpoint as JC
from mudg_tpu.train import step as JS
from mudg_tpu_torch import convert
from mudg_tpu_torch.apps import render_infer as TR
from mudg_tpu_torch.apps import train_mdm as TA
from mudg_tpu_torch.conditioning.tokenizer import HashTokenizer
from mudg_tpu_torch.data import latents as TL
from mudg_tpu_torch.data import waymo as TW
from mudg_tpu_torch.models import mdm as TMDM
from mudg_tpu_torch.models import presets as TP
from mudg_tpu_torch.nn import vae as TV
from mudg_tpu_torch.train import checkpoint as TC
from mudg_tpu_torch.train import step as TS
from test_torch_apps import scene_items
from test_torch_util import random_tree

H, W, VL = 32, 64, 4
RES = (H, W)
TASKS = ("color", "semantic", "depth", "normal")
SIZE = ["--preset", "tiny", "--height", str(H), "--width", str(W), "--video_length", str(VL),
        "--device", "cpu"]


@pytest.fixture(scope="module")
def items(scene, tmp_path_factory):
    """The scene's one camera window as 4 items, each with a dense normal
    base of (1, H, W, 3) .npy maps (the fixture has none), over a copy of
    the session's scene: the moment caches written beside its frames must
    not reach the other tests of the worker (tests/test_latents.py counts
    the caches it writes into the shared scene)."""
    root = tmp_path_factory.mktemp("train_items")
    path = scene_items(shutil.copytree(scene, root / "scene"), root / "items.txt", 4)
    ndir = root / "normal"
    os.makedirs(ndir)
    rng = np.random.default_rng(80)
    for i in range(4):
        np.save(ndir / f"{i:08d}.npy", rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32))
    listed = [dict(it, dense_normal_base=str(ndir)) for it in TW.read_items(path)]
    TW.write_items(path, listed)
    return path


@pytest.fixture(scope="module")
def vae_tree():
    return random_tree(jax.eval_shape(
        lambda: JMDM.init_mdm(jax.random.PRNGKey(0), JP.tiny()))["vae"], 81)


@pytest.fixture(scope="module")
def caches(items, vae_tree):
    """The moment caches of every frame the items touch, written by the
    port's `precompute` (tiny VAE, random weights)."""
    vae = convert.load_tree(TV.AutoencoderKL(TP.tiny().vae), vae_tree, device="cpu").eval()
    n = TL.precompute(TW.read_items(items), vae, RES, batch=4, skip_existing=False, log=None)
    assert n == len(TL.collect_jobs(TW.read_items(items), RES))
    return items


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("task", TASKS)
def test_load_item_matches_jax(items, caches, task):
    """`load_item` (pixels) and `load_item_latents` (moments) of every item
    for `task`, and with the task drawn from the seeded generator, bit for
    bit equal to the JAX dataset's."""
    for latents in (False, True):
        ours = TW.WaymoDataset(items, resolution=RES, seed=5, latents=latents)
        ref = JW.WaymoDataset(items, resolution=RES, seed=5, latents=latents)
        for i in range(len(ours)):
            _equal(ours.load_item(i, task), ref.load_item(i, task))
    labels = TASKS[:3] if task != "normal" else ("color", "normal")
    ours = TW.WaymoDataset(items, resolution=RES, seed=6, train_labels=labels)
    ref = JW.WaymoDataset(items, resolution=RES, seed=6, train_labels=labels)
    for i in range(8):
        _equal(ours.load_item(i), ref.load_item(i))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("accum", [1, 2])
def test_batch_loader_matches_jax(items, caches, prefetch, accum):
    """Two epochs of batches, shuffled from the seed, (accum, B, ...) with
    accum 2, prefetched in a thread or not, in the pixel and moments forms:
    the same batches in the same order, bit for bit."""
    tok = HashTokenizer()
    for latents in (False, True):
        got, want = [], []
        for W_, out in ((TW, got), (JW, want)):
            ds = W_.WaymoDataset(items, resolution=RES, seed=3, latents=latents)
            loader = W_.BatchLoader(ds, 1, accum_steps=accum, tokenizer=tok, seed=4,
                                    prefetch=prefetch)
            for _ in range(2):
                out.extend(loader)
        assert len(got) == len(want) == 2 * 4 // accum
        for a, b in zip(got, want):
            _equal(a, b)
            assert a["sparse_moments" if latents else "sparse_frames"].shape[:2] == (
                (accum, 1) if accum > 1 else (1, VL))


def test_batch_loader_reraises_at_the_consumer(items):
    """An item that fails to load raises from the consumer's loop, as in JAX."""
    ds = TW.WaymoDataset(items, resolution=RES, seed=3, latents=True)
    ds.resolution = (16, 16)   # no cache at this resolution
    with pytest.raises(FileNotFoundError, match="precompute-latents"):
        list(TW.BatchLoader(ds, 1, prefetch=2))


def test_item_lists_match_jax(scene, items, tmp_path):
    """make_item_list, make_virtual_item_list, write_items and collect_jobs
    equal the JAX package's."""
    for kw in ({}, {"window": 2, "stride": 1, "val_every": 2}):
        assert TW.make_item_list(scene, **kw) == JW.make_item_list(scene, **kw)
    for kw in ({"window": 4}, {"window": 2, "virtual_index": 3, "stride": 1}):
        assert TW.make_virtual_item_list(scene, **kw) == JW.make_virtual_item_list(scene, **kw)
    listed = TW.read_items(items)
    TW.write_items(str(tmp_path / "a.txt"), listed)
    JW.write_items(str(tmp_path / "b.txt"), listed)
    assert open(tmp_path / "a.txt").read() == open(tmp_path / "b.txt").read()
    assert TL.collect_jobs(listed, RES) == JL.collect_jobs(listed, RES)
    assert TL.latent_path("/a/b.jpg", RES, "n") == JL.latent_path("/a/b.jpg", RES, "n")


def test_precompute_matches_jax(items, caches, vae_tree):
    """The port's fp16 moment files (written by the `caches` fixture, bf16
    encode) against JAX `precompute` on the same weights in fp32 (files
    rewritten in place), within the JAX bf16 encode's error budget;
    `encode_moments` alone gives the same files' values."""
    jobs = TL.collect_jobs(TW.read_items(items), RES)
    ours = [np.load(TL.latent_path(p, RES, k)) for p, k in jobs]
    vc = TP.tiny().vae
    f = 2 ** (len(vc.ch_mult) - 1)
    assert all(m.dtype == np.float16 and m.shape == (H // f, W // f, 2 * vc.embed_dim)
               for m in ours)
    vae = convert.load_tree(TV.AutoencoderKL(TP.tiny().vae), vae_tree, device="cpu").eval()
    px = np.stack([TL.load_pixels(p, RES, k) for p, k in jobs[:4]])
    direct = TL.encode_moments(vae, torch.from_numpy(px)).numpy()
    for a, b in zip(direct, ours[:4]):
        assert np.array_equal(a, b)
    jvae = jax.tree.map(jax.numpy.asarray, vae_tree)
    ref = {}
    try:
        for dt in (None, jax.numpy.float32):   # bf16 (precompute's own), fp32
            n = JL.precompute(TW.read_items(items), jvae, JP.tiny().vae, RES, batch=4,
                              skip_existing=False, dtype=dt, log=None)
            assert n == len(jobs)
            ref[dt] = np.stack([np.load(JL.latent_path(p, RES, k)) for p, k in jobs])
    finally:   # the port's caches back, for the tests that read them
        TL.precompute(TW.read_items(items), vae, RES, batch=4, skip_existing=False, log=None)
    r32 = ref[jax.numpy.float32].astype(np.float32)

    def rel(a):
        return float(np.linalg.norm(a.astype(np.float32) - r32) / np.linalg.norm(r32))

    e_jax, e_port = rel(ref[None]), rel(np.stack(ours))
    assert e_port <= 1.5 * e_jax + 5e-3, (e_port, e_jax)


def _jax_names(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_names(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("stage", [1, 2])
def test_recipe_and_grad_mask_match_jax(stage):
    """--stage 1/2 (with and without --preset tiny): the MDMConfig, the
    resolution and the TrainConfig the JAX app builds, and stage 2's grad
    mask (the temporal transformers frozen) leaf for leaf."""
    for preset in (None, "tiny"):
        args = TA.parser().parse_args(["--items", "x", "--out", "y", "--stage", str(stage),
                                       "--use_ema", *(["--preset", preset] if preset else [])])
        cfg, res, frozen = TA.recipe(args)
        assert res == ((320, 512) if stage == 1 else (576, 1024))
        assert frozen == (stage == 2)
        jcfg = (JMDM.MDMConfig(base_scale=0.7) if stage == 1 else JMDM.stage2_config())
        if preset:
            jcfg = JP.get(preset)
        assert cfg.base_scale == jcfg.base_scale and cfg.unet.__dict__ == jcfg.unet.__dict__
        tc = TS.TrainConfig(learning_rate=args.lr, accum_steps=args.accum,
                            use_ema=args.use_ema, temporal_frozen=frozen)
        jtc = JS.TrainConfig(learning_rate=args.lr, accum_steps=args.accum,
                             use_ema=args.use_ema, temporal_frozen=frozen)
        assert tc.__dict__ == jtc.__dict__
    cfg = TP.tiny()
    with torch.device("meta"):
        mdm = TMDM.MDM(cfg)
    ours = {"unet." + n: v for n, v in TS.temporal_frozen_mask(mdm.unet).items()}
    params = jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), JP.tiny().unet))
    ref = {"unet." + n: v for n, v in _jax_names(JS.temporal_frozen_mask(
        JP.tiny().unet, params)).items()}
    assert ours == ref and not all(ours.values())


def _run(items, out, *extra):
    return TA.main(["--items", items, "--out", str(out), *SIZE, "--batch_size", "1",
                    "--accum", "2", "--log_every", "1", *extra])


def _records(out):
    return [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]


def test_train_app_end_to_end(items, caches, tmp_path):
    """3 steps with EMA, validation and a sample at step 3: the records,
    step_3, trainstate_2, final (loaded strictly by the port's render app),
    the sample's mp4."""
    out = tmp_path / "run"
    assert _run(items, out, "--max_steps", "3", "--ckpt_every", "3", "--full_ckpt_every", "2",
                "--use_ema", "--val_items", items, "--val_every", "3", "--sample_every", "3") == 0
    recs = _records(out)
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["sec_per_step"] > 0
               for r in recs if "loss" in r)
    val = [r for r in recs if "val_loss" in r]
    assert len(val) == 1 and val[0]["step"] == 3 and np.isfinite(val[0]["val_loss"])
    assert sorted(os.listdir(out)) == ["final", "metrics.jsonl", "samples", "step_3",
                                       "trainstate_2"]
    assert os.listdir(out / "samples") == ["step_3.mp4"]
    ts = TC.load(str(out / "trainstate_2"))
    assert ts["step"] == 2 and ts["count"] == 2 and ts["ema"] is not None
    assert sorted(ts["params"]) == sorted(ts["mu"]) == sorted(ts["nu"]) == sorted(ts["ema"])
    mdm = TR.load_params(argparse.Namespace(ckpt=str(out / "final")), TP.tiny(), "cpu")
    final = TC.load(str(out / "final"))
    assert all(torch.equal(v, final[k]) for k, v in mdm.state_dict().items())


def test_train_app_profile_dir(items, caches, tmp_path):
    """--profile_dir: one step under the profiler, its Chrome trace carrying
    the program's spans, which are off again after the run."""
    from mudg_tpu_torch.utils import profiling

    prof = tmp_path / "prof"
    assert _run(items, tmp_path / "run", "--max_steps", "1", "--profile_dir", str(prof)) == 0
    trace = (prof / "trace.json").read_text()
    assert '"mudg.unet"' in trace and '"mudg.unet.res"' in trace
    assert profiling.span("unet") is profiling.span("unet.res")


def test_train_app_auto_resume_and_sigusr1(items, caches, tmp_path, capsys):
    """SIGUSR1 at step 1 saves step_1 and trainstate_1; --auto_resume then
    restores trainstate_2 (newer than step_1) bit for bit and runs step 3;
    with --use_ema flipped the restore falls back to the weights alone; with
    only a step_N it restores the weights at that step."""
    out = tmp_path / "run"
    common = ["--ckpt_every", "100", "--full_ckpt_every", "2", "--use_ema"]
    args = TA.parser().parse_args(["--items", items, "--out", str(out), *SIZE, "--batch_size",
                                   "1", "--accum", "2", "--log_every", "1", "--max_steps", "2",
                                   *common])
    loader, _ = TA.loaders(args, RES, HashTokenizer())

    def on_step(step_i, state, metrics):
        if step_i == 1:
            os.kill(os.getpid(), signal.SIGUSR1)

    r = TA.train(args, loader, tokenizer=HashTokenizer(), on_step=on_step)
    assert sorted(os.listdir(out)) == ["final", "metrics.jsonl", "step_1", "trainstate_1",
                                       "trainstate_2"]
    kept = TC.train_state(r["state"])
    capsys.readouterr()
    assert _run(items, out, "--max_steps", "3", "--auto_resume", *common) == 0
    assert "auto-resume: restored trainstate_2 at step 2" in capsys.readouterr().out
    assert [r["step"] for r in _records(out) if "loss" in r] == [1, 2, 3]

    state = TS.init_train_state(TA.load_model(args, TP.tiny(), "cpu"),
                                TS.TrainConfig(use_ema=True))
    assert TA.auto_resume(args, state, "cpu") == 2
    for key, got in (("params", state.params), ("mu", state.mu), ("nu", state.nu),
                     ("ema", state.ema)):
        assert sorted(got) == sorted(kept[key])
        assert all(torch.equal(got[n], kept[key][n]) for n in got), key
    assert state.count == kept["count"] == 2 and state.step == 2

    state = TS.init_train_state(TA.load_model(args, TP.tiny(), "cpu"), TS.TrainConfig())
    capsys.readouterr()
    assert TA.auto_resume(args, state, "cpu") == 2
    assert "restoring weights only" in capsys.readouterr().out
    assert all(torch.equal(state.params[n], kept["params"][n]) for n in state.params)
    assert state.count == 0 and state.ema is None

    for f in ("trainstate_1", "trainstate_2"):
        os.remove(out / f)
    state = TS.init_train_state(TA.load_model(args, TP.tiny(), "cpu"), TS.TrainConfig())
    assert TA.auto_resume(args, state, "cpu") == 1 and state.step == 1
    step1 = TC.load(str(out / "step_1"))
    assert all(torch.equal(state.params[n], step1[n]) for n in state.params)


def test_train_app_latents(items, caches, tmp_path):
    """precompute-latents over the items (random tiny VAE), then 2 steps in
    the moments form with a sample at step 2."""
    from mudg_tpu_torch.__main__ import main

    assert main(["precompute-latents", "--items", items, "--preset", "tiny", "--height",
                 str(H), "--width", str(W), "--batch", "4", "--device", "cpu"]) == 0
    out = tmp_path / "run"
    assert main(["train", "--items", items, "--out", str(out), *SIZE, "--batch_size", "1",
                 "--accum", "2", "--log_every", "1", "--max_steps", "2", "--latents",
                 "--sample_every", "2", "--ckpt_every", "2", "--full_ckpt_every", "0"]) == 0
    assert [r["step"] for r in _records(out) if "loss" in r] == [1, 2]
    assert sorted(os.listdir(out)) == ["final", "metrics.jsonl", "samples", "step_2"]


@pytest.mark.parametrize("flag", ["--tp", "--sp"])
def test_train_app_multi_gpu_flags_exit_2(items, tmp_path, flag):
    with pytest.raises(SystemExit) as e:
        _run(items, tmp_path / "run", "--max_steps", "1", flag, "2")
    assert e.value.code == 2 and not os.path.exists(tmp_path / "run")


def test_train_app_ckpt_surgery_import(items, caches, tmp_path, monkeypatch):
    """A synthetic DynamiCrafter .ckpt (8-channel conv_in, no class_embed):
    the app's model equals JAX load_mudg_checkpoint(..., expand_conv_in=True,
    add_class_embed=True) bit for bit, and trains a step from it."""
    cfg = JP.tiny()
    tree = random_tree(jax.eval_shape(lambda: JMDM.init_mdm(jax.random.PRNGKey(0), cfg)), 82)
    export = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
              "image_proj": "image_proj_model.", "clip_text": "cond_stage_model.model.",
              "clip_image": "embedder.model.visual."}
    sd = {}
    for name, prefix in export.items():
        sd.update(JC.pytree_to_state_dict(tree[name], prefix=prefix))
    sd = {k: v for k, v in sd.items() if ".class_embed." not in k}
    conv_in = "model.diffusion_model.input_blocks.0.0.weight"
    sd[conv_in] = np.ascontiguousarray(sd[conv_in][:, :8])
    path = str(tmp_path / "dc.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, path)
    out = tmp_path / "run"
    args = TA.parser().parse_args(["--items", items, "--out", str(out), *SIZE, "--ckpt", path])
    mdm = TA.load_model(args, TP.tiny(), "cpu")
    ref = JC.load_mudg_checkpoint(path, expand_conv_in=True, add_class_embed=True)
    ref = {"unet": ref["unet"], "vae": ref["vae"], "image_proj": ref["image_proj"],
           "clip_text": ref["clip_text"]["model"], "clip_image": ref["clip_image"]["model"]["visual"]}
    got = mdm.state_dict()
    for name, sub in ref.items():
        for k, v in convert.tree_to_state_dict(sub).items():
            assert torch.equal(got[f"{name}.{k}"], v), (name, k)
    assert got["unet.input_blocks.0.0.weight"].shape[1] == 12
    assert torch.equal(got["unet.class_embed.0.weight"], got["unet.time_embed.0.weight"])
    monkeypatch.setenv("MUDG_ALLOW_HASH_TOKENIZER", "1")
    assert _run(items, out, "--ckpt", path, "--max_steps", "1", "--ckpt_every", "1",
                "--full_ckpt_every", "0") == 0
    assert sorted(os.listdir(out)) == ["final", "metrics.jsonl", "step_1"]
