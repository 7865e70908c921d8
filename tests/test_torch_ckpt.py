"""The port's checkpoint import, `init_mdm`, tokenizers and condition
loading against the JAX package's, on the CPU (numpy and torch; no JAX
compile).

The checkpoint is a tiny MuDG `.ckpt` written here: the keys of JAX
`pytree_to_state_dict` of a random tiny tree under the sub-model prefixes,
with the legacy `framestride_embed` name, an fp16 leaf, an 8-channel
conv_in, diffusion buffers that are skipped, and its DeepSpeed `module`
form. `init_mdm` is held to the laws of JAX `init_mdm`, run with its random
draws replaced by numpy fills that mark them: each uniform draw alternates
its two bounds, each normal draw is all ones (so a normal leaf is its
scale). The flat state-dict readers (torch pickle, safetensors) and the
apps' media helpers are held to JAX's on files and arrays made here.
"""
from __future__ import annotations

import gzip
import json
import math
import re
import struct

import jax
import numpy as np
import pytest
import torch

from mudg_tpu.conditioning import tokenizer as JT
from mudg_tpu.data import conditions as JDC
from mudg_tpu.models import mdm as JMDM
from mudg_tpu.models import presets as JP
from mudg_tpu.train import checkpoint as JC
from mudg_tpu.utils import media as JM
from mudg_tpu_torch import convert
from mudg_tpu_torch.conditioning import tokenizer as TT
from mudg_tpu_torch.data import conditions as TDC
from mudg_tpu_torch.models import mdm as TMDM
from mudg_tpu_torch.models import presets as TP
from mudg_tpu_torch.train import checkpoint as TC
from mudg_tpu_torch.utils import media as TM
from test_torch_util import random_tree

# where each sub-model's own keys sit in a MuDG checkpoint (ddpm3d.py:86,529-530,1037-1041)
EXPORT = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
          "image_proj": "image_proj_model.", "clip_text": "cond_stage_model.model.",
          "clip_image": "embedder.model.visual."}
CONV_IN = "model.diffusion_model.input_blocks.0.0.weight"
HALF = "model.diffusion_model.time_embed.2.weight"


def jax_subtrees(trees):
    """The sub-trees JAX render_infer.load_params takes (:36-42)."""
    return {"unet": trees["unet"], "vae": trees["vae"], "image_proj": trees["image_proj"],
            "clip_text": trees["clip_text"].get("model", trees["clip_text"]),
            "clip_image": trees["clip_image"].get("model", {}).get("visual",
                                                                   trees["clip_image"])}


def write_ckpt(path, sd, deepspeed=False):
    tsd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    tsd[HALF] = tsd[HALF].half()
    if deepspeed:
        torch.save({"module": {"_forward_module." + k.replace("framestride_embed",
                                                              "fps_embedding"): v
                               for k, v in tsd.items()}}, path)
    else:
        torch.save({"state_dict": tsd, "epoch": 3, "global_step": 1000}, path)
    return str(path)


@pytest.fixture(scope="module")
def ckpt_sd():
    """A tiny MuDG state dict (numpy, torch layouts) as a .ckpt carries it."""
    cfg = JP.tiny()
    tree = random_tree(jax.eval_shape(lambda: JMDM.init_mdm(jax.random.PRNGKey(0), cfg)), 70)
    sd = {}
    for name, prefix in EXPORT.items():
        sd.update(JC.pytree_to_state_dict(tree[name], prefix=prefix))
    sd = {k.replace(".fps_embedding.", ".framestride_embed."): v for k, v in sd.items()}
    sd[CONV_IN] = (sd[CONV_IN][:, :8] * 2.0).copy()        # DynamiCrafter's 8-channel conv_in
    rng = np.random.default_rng(71)
    sd["betas"] = rng.random(1000).astype(np.float32)       # diffusion buffers, skipped
    sd["cond_stage_model.model.attn_mask"] = np.zeros((77, 77), np.float32)
    sd["model.diffusion_model.scale_arr"] = rng.random(1000).astype(np.float32)
    return sd


@pytest.mark.parametrize("expand", [False, True])
@pytest.mark.parametrize("deepspeed", [False, True])
def test_load_mudg_checkpoint_matches_jax(ckpt_sd, tmp_path, expand, deepspeed):
    """Key for key and bit for bit, each sub-model's state dict equals
    `convert.tree_to_state_dict` of JAX load_mudg_checkpoint's tree (the
    fp16 leaf as fp32, conv_in expanded to 12 channels or not); with the
    surgery the state dicts load into the port's MDM strictly."""
    path = write_ckpt(tmp_path / "m.ckpt", ckpt_sd, deepspeed)
    ours = TC.load_mudg_checkpoint(path, expand_conv_in=expand, add_class_embed=expand)
    ref = jax_subtrees(JC.load_mudg_checkpoint(path, expand_conv_in=expand,
                                               add_class_embed=expand))
    assert set(ours) == set(ref)
    for name, tree in ref.items():
        want = convert.tree_to_state_dict(tree)
        assert sorted(ours[name]) == sorted(want), name
        for k, v in want.items():
            got = ours[name][k]
            assert got.dtype == v.dtype == torch.float32 and torch.equal(got, v), (name, k)
    w = ours["unet"]["input_blocks.0.0.weight"]
    assert w.shape[1] == (12 if expand else 8)
    assert "fps_embedding.2.weight" in ours["unet"]
    assert torch.equal(ours["unet"]["time_embed.2.weight"],
                       torch.from_numpy(ckpt_sd[HALF]).half().float())
    if expand:
        with torch.device("meta"):
            mdm = TMDM.MDM(TP.tiny())
        mdm.to_empty(device="cpu")
        TC.load_into(mdm, ours)
        assert torch.equal(mdm.unet.state_dict()["input_blocks.0.0.weight"], w)


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_strict_load_names_the_key(ckpt_sd, tmp_path, fault):
    """A key the MDM lacks, or one it needs that the checkpoint lacks,
    raises and names the key."""
    sd = dict(ckpt_sd)
    sd[CONV_IN] = np.concatenate([sd[CONV_IN]] * 2, axis=1)[:, :12]
    key = "model.diffusion_model.out.2.bias"
    if fault == "missing":
        del sd[key]
    else:
        key = "model.diffusion_model.out.3.bias"
        sd[key] = np.zeros(4, np.float32)
    trees = TC.load_mudg_checkpoint(write_ckpt(tmp_path / "m.ckpt", sd))
    with torch.device("meta"):
        mdm = TMDM.MDM(TP.tiny())
    mdm.to_empty(device="cpu")
    with pytest.raises(RuntimeError, match=key.replace("model.diffusion_model.", "")):
        TC.load_into(mdm, trees)


def meta_mdm():
    with torch.device("meta"):
        mdm = TMDM.MDM(TP.tiny())
    return mdm.to_empty(device="cpu")


@pytest.mark.parametrize("stray", [None, "cond_stage_model.model.text_projection_2",
                                   "embedder.model.visual.ln_post.extra"])
def test_open_clip_leaves_the_towers_never_read(ckpt_sd, tmp_path, stray):
    """A published checkpoint pickles whole open_clip models: the text
    model's text_projection and logit_scale, the visual tower's ln_post and
    proj. JAX loads them and reads none; the port drops them by name and
    loads the rest strictly, the same state dicts as without them. Any
    other key the towers lack still raises and names the key."""
    w_text = ckpt_sd["cond_stage_model.model.ln_final.weight"].shape[0]
    w_vis = ckpt_sd["embedder.model.visual.ln_pre.weight"].shape[0]
    rng = np.random.default_rng(72)
    extra = {"cond_stage_model.model.text_projection":
             rng.standard_normal((w_text, w_text)).astype(np.float32),
             "cond_stage_model.model.logit_scale": np.float32(4.6),
             "embedder.model.visual.ln_post.weight": np.ones(w_vis, np.float32),
             "embedder.model.visual.ln_post.bias": np.zeros(w_vis, np.float32),
             "embedder.model.visual.proj":
             rng.standard_normal((w_vis, w_text)).astype(np.float32)}
    if stray:
        extra[stray] = np.zeros(3, np.float32)
    path = write_ckpt(tmp_path / "m.ckpt", {**ckpt_sd, **extra})
    ref = jax_subtrees(JC.load_mudg_checkpoint(path))
    assert {"text_projection", "logit_scale"} <= set(ref["clip_text"])
    assert {"ln_post", "proj"} <= set(ref["clip_image"])
    surgery = {"expand_conv_in": True, "add_class_embed": True}
    ours = TC.load_mudg_checkpoint(path, **surgery)
    if stray:
        key = stray.split(".model.", 1)[1].removeprefix("visual.")
        with pytest.raises(RuntimeError, match=re.escape(f'"{key}"')):
            TC.load_into(meta_mdm(), ours)
        return
    plain = TC.load_mudg_checkpoint(write_ckpt(tmp_path / "plain.ckpt", ckpt_sd), **surgery)
    for name, sd in plain.items():
        assert sorted(ours[name]) == sorted(sd), name
        assert all(torch.equal(ours[name][k], v) for k, v in sd.items()), name
    TC.load_into(meta_mdm(), ours)


def write_safetensors(path, arrays):
    """A safetensors file: 8-byte LE header length, the JSON header, one
    buffer; bf16 leaves given as their uint16 bits."""
    names = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
             np.dtype(np.int64): "I64", np.dtype(np.uint8): "U8"}
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for k, (dt, a) in arrays.items():
        raw = np.ascontiguousarray(a).tobytes()
        header[k] = {"dtype": dt or names[a.dtype], "shape": list(a.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))
    return str(path)


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_load_torch_state_dict_matches_jax(tmp_path, fmt):
    """load_torch_state_dict of a flat state dict (a torch.save'd .pth with
    fp16, bf16, int64, a 0-d and a non-contiguous tensor; a safetensors file
    with F32, F16, BF16, I64 and U8 leaves) gives JAX's arrays, key for key,
    dtype for dtype, bit for bit."""
    rng = np.random.default_rng(73)
    a = rng.standard_normal((6, 10)).astype(np.float32)
    if fmt == "pth":
        path = str(tmp_path / "sd.pth")
        torch.save({"w": torch.from_numpy(a), "h": torch.from_numpy(a).half(),
                    "b": torch.from_numpy(a).bfloat16(), "i": torch.arange(7),
                    "s": torch.tensor(2.5), "t": torch.from_numpy(a).t()}, path)
    else:
        bits = (a.view(np.uint32) >> 16).astype(np.uint16)
        path = write_safetensors(tmp_path / "sd.safetensors", {
            "w": (None, a), "h": (None, a.astype(np.float16)), "b": ("BF16", bits),
            "i": (None, np.arange(7, dtype=np.int64)),
            "u": (None, rng.integers(0, 255, (3, 4), dtype=np.uint8))})
    ours, ref = TC.load_torch_state_dict(path), JC.load_torch_state_dict(path)
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        o, r = np.asarray(ours[k]), np.asarray(r)
        assert o.dtype == r.dtype and o.shape == r.shape, k
        np.testing.assert_array_equal(o, r, err_msg=k)
    if fmt == "pth":
        np.testing.assert_array_equal(ours["t"], a.T)


@pytest.mark.parametrize("fn", ["spectral_colormap", "visualize_depth", "to_uint8",
                                "side_by_side"])
def test_media_helpers_match_jax(fn):
    """The apps' savers' array helpers give JAX's arrays bit for bit on
    values past both ends of their ranges."""
    rng = np.random.default_rng(74)
    if fn == "spectral_colormap":
        x = rng.uniform(-0.2, 1.2, (16, 24)).astype(np.float32)
        cases = [((x,), {}), ((x,), {"reverse": True})]
    elif fn == "visualize_depth":
        d = rng.uniform(-5, 120, (16, 24)).astype(np.float32)
        cases = [((d,), {}), ((d,), {"vmin": 0, "vmax": 100}), ((np.full_like(d, 3.0),), {})]
    elif fn == "to_uint8":
        cases = [((rng.uniform(-1.3, 1.3, (2, 16, 24, 3)).astype(np.float32),), {})]
    else:
        v = [rng.integers(0, 255, (3, 16, 8 * i, 3), dtype=np.uint8) for i in (1, 2, 3)]
        cases = [((v[0], v[1]), {}), (tuple(v), {})]
    for args, kw in cases:
        o, r = getattr(TM, fn)(*args, **kw), getattr(JM, fn)(*args, **kw)
        assert o.dtype == r.dtype and o.shape == r.shape, (fn, kw)
        np.testing.assert_array_equal(o, r, err_msg=f"{fn} {kw}")


@pytest.fixture(scope="module")
def jax_init_laws():
    """JAX init_mdm (tiny) with its draws replaced by marking fills, as a
    torch-layout state dict."""
    def split(key, num=2):
        return [None] * num

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        a = np.empty(shape, np.float32)
        a.flat[0::2], a.flat[1::2] = minval, maxval
        return a

    def normal(key, shape=(), dtype=None):
        return np.ones(shape, np.float32)

    mp = pytest.MonkeyPatch()
    for name, fn in (("split", split), ("uniform", uniform), ("normal", normal)):
        mp.setattr(jax.random, name, fn)
    try:
        tree = JMDM.init_mdm(None, JP.tiny())
    finally:
        mp.undo()
    return {k: v.numpy() for k, v in convert.tree_to_state_dict(tree).items()}


def test_init_mdm_draws_the_jax_laws(jax_init_laws):
    """The port's init_mdm (tiny, a seeded generator) against JAX's laws:
    the same all-zero and all-one leaves; every uniform leaf within its JAX
    bound and, from 256 elements, its std within 15% of bound / sqrt(3);
    every normal leaf within 6 times its JAX scale and, from 256 elements, its
    std within 15% of the scale."""
    ours = {k: v.numpy() for k, v in
            TMDM.init_mdm(TP.tiny(), torch.Generator().manual_seed(0)).state_dict().items()}
    laws = jax_init_laws
    assert sorted(ours) == sorted(laws)

    def is_const(a, v):
        return bool(np.all(a == v))

    zeros = {k for k, a in laws.items() if is_const(a, 0.0)}
    ones = {k for k, a in laws.items() if is_const(a, 1.0)}
    assert zeros == {k for k, a in ours.items() if is_const(a, 0.0)}
    assert ones == {k for k, a in ours.items() if is_const(a, 1.0)}
    assert "unet.out.2.weight" in zeros and "unet.fps_embedding.2.bias" in zeros
    assert "vae.encoder.mid.attn_1.proj_out.weight" not in zeros
    n_uniform = n_normal = 0
    for k, law in laws.items():
        if k in zeros or k in ones:
            continue
        a = ours[k]
        b = float(np.abs(law).max())
        normal = is_const(law, law.flat[0])   # all ones, scaled
        if normal:
            n_normal += 1
            assert np.abs(a).max() <= 6 * b, k
            expect_std = b
        else:
            n_uniform += 1
            assert law.min() == -b and law.max() == b, k   # both bounds drawn
            assert np.abs(a).max() <= b, k
            expect_std = b / math.sqrt(3)
        if a.size >= 256:
            assert abs(a.std() / expect_std - 1) <= 0.15, (k, a.std(), expect_std)
    assert n_normal == 5 and n_uniform > 100


BPE_MERGES = ["h e", "l l", "he ll", "o</w>", "hell o</w>", "t h", "th e</w>", "d r", "i v",
              "dr iv", "in g</w>", "driv ing</w>", "s c", "sc en", "scen e</w>"]
TEXTS = ["Hello the world", "A photo a of driving scene.", "cafÃ© &amp; the",
         "", "  Many   spaces,  the END!  "]


@pytest.mark.parametrize("fmt", ["merges.txt", "bpe_simple_vocab_16e6.txt.gz"])
def test_clip_tokenizer_matches_jax(tmp_path, fmt):
    """ClipTokenizer on a small merge table written here (both of its file
    forms) and HashTokenizer give JAX's ids."""
    path = tmp_path / fmt
    if fmt.endswith(".gz"):
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write("\n".join(["#version: 0.2", *BPE_MERGES]) + "\n")
    else:
        path.write_text("\n".join(["#version: 0.2", *BPE_MERGES]) + "\n")
    ours, ref = TT.ClipTokenizer(str(path)), JT.ClipTokenizer(str(path))
    np.testing.assert_array_equal(ours(TEXTS), ref(TEXTS))
    assert ours(TEXTS).dtype == np.int32 and ours(TEXTS).shape == (len(TEXTS), 77)
    assert ours.encode("driving the scene") == ref.encode("driving the scene")
    np.testing.assert_array_equal(TT.HashTokenizer()(TEXTS), JT.HashTokenizer()(TEXTS))
    assert isinstance(TT.default_tokenizer(str(path)), TT.ClipTokenizer)


def test_default_tokenizer_refuses_hash_ids_for_real_weights(monkeypatch):
    for mod in (TT, JT):
        monkeypatch.setattr(mod, "_hf_cache_merges", lambda: [])
    monkeypatch.delenv("MUDG_BPE_PATH", raising=False)
    monkeypatch.delenv("MUDG_ALLOW_HASH_TOKENIZER", raising=False)
    for mod in (TT, JT):
        with pytest.raises(FileNotFoundError):
            mod.default_tokenizer(None, require_real=True)
        assert isinstance(mod.default_tokenizer(None), mod.HashTokenizer)
    monkeypatch.setenv("MUDG_ALLOW_HASH_TOKENIZER", "1")
    assert isinstance(TT.default_tokenizer(None, require_real=True), TT.HashTokenizer)


@pytest.mark.parametrize("override", [False, True])
def test_condition_loading_matches_jax(scene, override):
    """get_task_frames for each task and get_sparse_depth equal JAX's arrays
    on the synthetic scene (resized and center-cropped to 32x64), also with
    a per-base `*_frames` override of the sparse condition's names."""
    import os

    cam = "camera_FRONT"
    frames = [f"{i:08d}.jpg" for i in range(4)]
    item = {"frames": frames,
            "dense_color_base": os.path.join(scene, "images", cam),
            "sparse_color_base": os.path.join(scene, "images", cam),
            "dense_semantic_base": os.path.join(scene, "semantic_dense", cam),
            "dense_depth_base": os.path.join(scene, "six_frames_depth", cam),
            "sparse_depth_base": os.path.join(scene, "six_frames_depth", cam)}
    if override:
        item["sparse_color_base_frames"] = frames[::-1]
    for task in ("color", "depth", "semantic"):
        ours = TDC.get_task_frames(item, task, (32, 64))
        ref = JDC.get_task_frames(item, task, (32, 64))
        assert ours["class_label"] == ref["class_label"]
        for k in ("dense_frames", "sparse_frames"):
            assert ours[k].shape == (4, 32, 64, 3) and ours[k].dtype == np.float32
            np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_array_equal(TDC.get_sparse_depth(item, (32, 64)),
                                  JDC.get_sparse_depth(item, (32, 64)))
