"""The port's SegFormer and segmentation stage against the JAX package, on the CPU.

- A tiny SegFormer (B0 widths, one block per stage, a 64x96 image) with
  random weights: the port's logits, upsampled logits and `segment` ids
  against JAX's `segformer_apply` and `segment` (ids equal wherever JAX's
  top-2 margin is clear of the fp32 difference).
- The bilinear upsampling against `jax.image.resize` at integer and
  non-integer factors, the edges included.
- The HF layout: B3's module keys and shapes equal JAX's `init_segformer`
  tree flattened to torch layouts; an HF-named state dict as
  `pytorch_model.bin` and as `model.safetensors` through
  `load_segformer_predictor` (explicit path, MUDG_SEGFORMER_PATH, None when
  nothing resolves), held against JAX's `segment`.
- The PFM writer and reader against JAX's, bit for bit, and `segment_frames`
  against JAX's over the scene fixture's frames.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudg_tpu.data import segmentation as JSEG
from mudg_tpu.models import segformer as JS
from mudg_tpu_torch import convert
from mudg_tpu_torch.data import segmentation as TSEG
from mudg_tpu_torch.models import segformer as TS
from test_torch_util import assert_close, random_tree, t

TOL = 1e-4   # tests/test_reference_oracle.py:46-53's fp32 tolerance
ATOL = 1e-5


def _tiny_cfgs():
    jcfg = dataclasses.replace(JS.SegFormerConfig.b0(), depths=(1, 1, 1, 1))
    tcfg = dataclasses.replace(TS.SegFormerConfig.b0(), depths=(1, 1, 1, 1))
    return jcfg, tcfg


def _tree(jcfg, seed=0):
    tree = random_tree(jax.eval_shape(lambda: JS.init_segformer(jax.random.PRNGKey(0), jcfg)),
                       seed)
    bn = tree["decode_head"]["batch_norm"]
    bn["running_var"] = np.abs(bn["running_var"]) + 0.5   # a variance is positive
    return tree


def _port(tcfg, tree):
    model = TS.SegFormer(tcfg)
    TS.load_hf_state_dict(model, convert.pytree_to_state_dict(tree))
    return model.eval()


def _image(seed=1, hw=(64, 96)):
    return np.random.default_rng(seed).uniform(0, 1, (*hw, 3)).astype(np.float32)


def _ids_agree(ours, jax_ids, jax_logits, slack):
    """Class ids equal wherever JAX's top-2 logit margin exceeds `slack`."""
    top2 = np.sort(jax_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > slack
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(ours)[clear], np.asarray(jax_ids)[clear])


def test_tiny_segformer_matches_jax():
    jcfg, tcfg = _tiny_cfgs()
    tree = _tree(jcfg)
    model = _port(tcfg, tree)
    img = _image()
    mean, std = np.array(TS.IMAGENET_MEAN), np.array(TS.IMAGENET_STD)
    x = ((img - mean) / std).astype(np.float32)[None]
    ref = np.asarray(JS.segformer_apply(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x)))
    with torch.no_grad():
        ours = model(t(x))
        full = TS.logits_full(model, t(img))
        ids = TS.segment(model, t(img))
    assert ref.shape == (1, 16, 24, 19)
    assert_close(ours, ref, TOL, ATOL, "logits")
    jp = jax.tree.map(jnp.asarray, tree)
    ref_full = np.asarray(JS._resize_bilinear(jnp.asarray(ref), img.shape[:2]))[0]
    assert_close(full, ref_full, TOL, ATOL, "upsampled logits")
    ref_ids = np.asarray(JS.segment(jp, jcfg, jnp.asarray(img)))
    assert ids.dtype == torch.int32 and ids.shape == img.shape[:2]
    _ids_agree(ids, ref_ids, ref_full, 2 * (TOL * np.abs(ref_full).max() + ATOL))


@pytest.mark.parametrize("src,dst", [((5, 7), (20, 28)), ((5, 7), (13, 17)), ((16, 24), (64, 96))])
def test_bilinear_upsampling_matches_jax_resize(src, dst):
    x = np.random.default_rng(2).standard_normal((2, *src, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), method="bilinear"))
    ours = TS.resize_bilinear(t(x), dst)
    assert_close(ours, ref, 1e-6, 1e-6, "resize")
    # the edge rows and columns, where the sample points fall outside the input
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert_close(ours.numpy()[sl], ref[sl], 1e-6, 1e-6, "edge")


def test_b3_keys_and_shapes_equal_jax_tree():
    """The port's B3 modules carry exactly JAX's `init_segformer` leaves,
    under HF's names and in torch layouts (plus BatchNorm's
    num_batches_tracked, which HF checkpoints hold)."""
    shapes = jax.eval_shape(lambda: JS.init_segformer(jax.random.PRNGKey(0),
                                                      JS.SegFormerConfig()))
    flat = {k: v.shape for k, v in convert.pytree_to_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    with torch.device("meta"):
        model = TS.SegFormer(TS.SegFormerConfig())
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours.pop("decode_head.batch_norm.num_batches_tracked") == ()
    theirs = {("segformer." + k if k.startswith("encoder.") else k): tuple(s)
              for k, s in flat.items()}
    assert ours == theirs
    assert "segformer.encoder.block.2.17.attention.self.sr.weight" in ours
    n = sum(np.prod(s) for s in ours.values())
    assert 46e6 < n < 48e6, n


def _hf_state_dict(tree):
    """JAX's tree as an HF checkpoint would hold it: segformer.encoder.*,
    decode_head.* and BatchNorm's num_batches_tracked."""
    sd = {("segformer." + k if k.startswith("encoder.") else k): v
          for k, v in convert.pytree_to_state_dict(tree).items()}
    sd["decode_head.batch_norm.num_batches_tracked"] = np.array(7, np.int64)
    return sd


def _write_safetensors(path, arrays):
    import json
    import struct

    header, bufs, off = {}, [], 0
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        dt = {"float32": "F32", "int64": "I64"}[a.dtype.name]
        header[name] = {"dtype": dt, "shape": list(a.shape), "data_offsets": [off, off + a.nbytes]}
        bufs.append(a.tobytes())
        off += a.nbytes
    hj = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        f.write(b"".join(bufs))


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_predictor_from_hf_checkpoint_matches_jax(tmp_path, monkeypatch, fmt):
    jcfg, tcfg = _tiny_cfgs()
    tree = _tree(jcfg, seed=3)
    sd = _hf_state_dict(tree)
    d = tmp_path / "ckpt"
    d.mkdir()
    if fmt == "bin":
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                   d / "pytorch_model.bin")
    else:
        _write_safetensors(d / "model.safetensors", sd)
    monkeypatch.delenv("MUDG_SEGFORMER_PATH", raising=False)
    assert TSEG.load_segformer_predictor(None, device="cpu", cfg=tcfg) is None
    monkeypatch.setenv("MUDG_SEGFORMER_PATH", str(d))
    by_env = TSEG.load_segformer_predictor(None, device="cpu", cfg=tcfg)
    monkeypatch.setenv("MUDG_SEGFORMER_PATH", str(tmp_path / "missing"))
    pred = TSEG.load_segformer_predictor(str(d), device="cpu", cfg=tcfg)
    assert pred is not None and by_env is not None
    img = (_image(4) * 255).astype(np.uint8)
    ids = pred(img)
    np.testing.assert_array_equal(ids, by_env(img))
    jp = jax.tree.map(jnp.asarray, tree)
    img01 = img.astype(np.float32) / 255.0
    ref_ids = np.asarray(JS.segment(jp, jcfg, jnp.asarray(img01)))
    mean, std = np.array(TS.IMAGENET_MEAN), np.array(TS.IMAGENET_STD)
    logits = JS.segformer_apply(jp, jcfg, jnp.asarray(((img01 - mean) / std)[None],
                                                      jnp.float32))
    ref_full = np.asarray(JS._resize_bilinear(logits, img.shape[:2]))[0]
    _ids_agree(ids, ref_ids, ref_full, 2 * (TOL * np.abs(ref_full).max() + ATOL))
    # JAX's own import of the same checkpoint gives the same tree
    again = JS.import_hf_state_dict(TSEG._read_weight_file(
        str(d / ("pytorch_model.bin" if fmt == "bin" else "model.safetensors"))))
    jax.tree.map(np.testing.assert_array_equal, again, tree)


def test_pfm_io_matches_jax(tmp_path):
    data = np.random.default_rng(5).integers(0, 19, (20, 30)).astype(np.float32)
    ours, theirs = str(tmp_path / "ours.pfm"), str(tmp_path / "theirs.pfm")
    TSEG.write_pfm(ours, data, scale=2.0)
    JSEG.write_pfm(theirs, data, scale=2.0)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back, scale = TSEG.read_pfm(theirs)
    np.testing.assert_array_equal(back, JSEG.read_pfm(ours)[0])
    np.testing.assert_array_equal(back, data)
    assert scale == 2.0


def test_segment_frames_matches_jax(tmp_path, scene):
    cam = "camera_FRONT"

    def stub(img):
        return (img[:, :, 0] // 14).astype(np.int64) % 19

    outs = {}
    for name, mod in (("ours", TSEG), ("theirs", JSEG)):
        n = mod.segment_frames(os.path.join(scene, "images", cam), str(tmp_path / name / "sem"),
                               cam, stub, palette_dir=str(tmp_path / name / "pal"))
        assert n == 4
        outs[name] = n
    for sub in ("sem/camera_FRONT/seg", "pal/camera_FRONT"):
        files = sorted(os.listdir(tmp_path / "theirs" / sub))
        assert files == sorted(os.listdir(tmp_path / "ours" / sub)) and len(files) == 4
        for f in files:
            a = open(tmp_path / "ours" / sub / f, "rb").read()
            b = open(tmp_path / "theirs" / sub / f, "rb").read()
            assert a == b, (sub, f)


def test_port_imports_no_hf_library_outside_a_guarded_lookup():
    """No port source imports transformers, huggingface_hub or safetensors
    except inside a try block (the local HF-cache lookup), so the port runs
    where none of them is installed."""
    import ast
    import pathlib

    root = pathlib.Path(TS.__file__).resolve().parents[1]
    banned = ("transformers", "huggingface_hub", "safetensors")
    bad, guarded = [], 0
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        inside_try = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Try):
                for stmt in node.body:
                    inside_try.update(id(n) for n in ast.walk(stmt))
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                if name.split(".")[0] in banned:
                    if id(node) in inside_try:
                        guarded += 1
                    else:
                        bad.append(f"{path.relative_to(root)}:{node.lineno} {name}")
    assert not bad, bad
    assert guarded == 2   # the HF-cache lookups of data/segmentation.py and the tokenizer
