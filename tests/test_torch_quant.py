"""The port's int8 serving (`mudg_tpu_torch/quant.py`, its dispatch in
`nn/functional.py`, the quantized load in `convert.py` and the apps) against
`mudg_tpu/quant.py` on the CPU, on seeded numpy weights and inputs:

- `quantize_weight`: absmax codes equal and scales within rtol 1e-6; with
  `clip_pct`, codes within 1 where the percentile interpolates (the bound
  tests/test_quant.py:186-189 allows JAX itself);
- `linear_i8`, `conv_i8` (1-3 spatial axes, stride 1 and 2, SAME and
  explicit padding, groups > 1), `temporal_conv311_i8` and the weight-only
  dequantization: fp32 outputs within 1e-6 * max|ref| (fp32 rounding);
- the layer selection of every `which` x `mode` x `min_size` (and
  `conv_mode`), by torch name, against JAX's `quantize_pytree` on the
  full-width UNet's shapes (`jax.eval_shape`, no compile), with
  `size_report`'s int8 bytes, and `conv_w8a8_to_w8`;
- a tiny quantized UNet forward in fp32 (the slice tolerance, 2e-3 *
  max|ref| + 5e-5) and bf16 (3e-2 * max|ref|), the JAX-quantized tree
  loaded through `convert.load_tree` beside the port's own quantization;
- the `quantize` app's artifact through `render --ckpt`, and `render
  --quantize` under `--seq_parallel` at 2 gloo ranks.
The per-mode kernel sites against the JAX dispatch, which need full-width
JAX traces, are in tests/test_torch_switches.py.
"""
from __future__ import annotations

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torch_parallel_ranks as R
from mudg_tpu import quant as JQ
from mudg_tpu.nn import functional as JF
from mudg_tpu.nn import unet3d as JU
from mudg_tpu_torch import convert
from mudg_tpu_torch import quant as Q
from mudg_tpu_torch.apps import quantize_ckpt as TQA
from mudg_tpu_torch.apps import render_infer as TR
from mudg_tpu_torch.models import presets as TP
from mudg_tpu_torch.nn import functional as TF
from mudg_tpu_torch.nn import unet3d as TU
from test_torch_apps import scene_items
from test_torch_model import SLICE_ATOL, SLICE_TOL, TINY_UNET
from test_torch_util import assert_close, port, random_tree, t, to_jax

OP_TOL = 1e-6
BF16_TOL = 3e-2
H, W, VL = 32, 64, 4
RENDER = ["--preset", "tiny", "--height", str(H), "--width", str(W), "--video_length", str(VL),
          "--steps", "1", "--max_windows", "1", "--dtype", "f32", "--device", "cpu"]


def _layer(kind, w, b=None):
    """A port layer holding the JAX-layout weight `w` in the torch layout."""
    w_t = convert.jax_to_torch_layout(kind + ".weight", w)
    m = {2: nn.Linear, 3: nn.Conv1d, 4: nn.Conv2d, 5: nn.Conv3d}[w.ndim](1, 1, 1)
    m.weight = nn.Parameter(t(np.ascontiguousarray(w_t)))
    m.bias = None if b is None else nn.Parameter(t(b))
    return m


@pytest.mark.parametrize("shape,clip", [((96, 64), None), ((3, 3, 16, 24), None),
                                        ((3, 1, 1, 32, 40), None), ((96, 64), 99.0),
                                        ((3, 3, 16, 24), 99.9)])
def test_quantize_weight_matches_jax(shape, clip):
    rng = np.random.default_rng(60)
    w = rng.normal(0, 0.05, shape).astype(np.float32)
    w[..., 3] *= 40.0   # an outlier channel
    j_i8, j_scale = (np.asarray(a) for a in JQ.quantize_weight(jnp.asarray(w), clip_pct=clip))
    w_t = convert.jax_to_torch_layout("x.weight", w)
    t_i8, t_scale = (a.numpy() for a in Q.quantize_weight(t(np.ascontiguousarray(w_t)),
                                                          clip_pct=clip))
    ref = convert.jax_to_torch_layout("x.weight", j_i8)
    assert t_i8.dtype == np.int8 and t_scale.dtype == np.float32
    np.testing.assert_allclose(t_scale, j_scale, rtol=1e-6, atol=0)
    diff = np.abs(t_i8.astype(int) - ref.astype(int))
    assert diff.max() <= (0 if clip is None else 1)


def _op_cases():
    """(name, JAX leaf shape, x shape, JAX call, port call)."""
    def conv(dn, **kw):
        return (lambda p, x: JQ.conv_i8(p, x, dimension_numbers=dn, **kw),
                lambda m, x: Q.conv_i8(m, x, **{**kw, "stride": kw["stride"][0]}))

    return [
        ("linear", (96, 64), (5, 7, 96), JQ.linear_i8, Q.linear_i8),
        ("conv2d_s1_same", (3, 3, 16, 24), (2, 9, 11, 16),
         *conv(("NHWC", "HWIO", "NHWC"), stride=(1, 1), padding="SAME")),
        ("conv2d_s2_same", (3, 3, 16, 24), (2, 9, 11, 16),
         *conv(("NHWC", "HWIO", "NHWC"), stride=(2, 2), padding="SAME")),
        ("conv2d_s2_pad", (3, 3, 16, 24), (2, 9, 11, 16),
         *conv(("NHWC", "HWIO", "NHWC"), stride=(2, 2), padding=((1, 1), (1, 1)))),
        ("conv2d_groups", (3, 3, 8, 24), (2, 9, 11, 16),
         *conv(("NHWC", "HWIO", "NHWC"), stride=(1, 1), padding=((0, 2), (1, 0)), groups=2)),
        ("conv2d_k1_c12", (1, 1, 12, 20), (2, 5, 6, 12),
         *conv(("NHWC", "HWIO", "NHWC"), stride=(1, 1), padding="SAME")),
        ("conv1d", (3, 16, 24), (2, 13, 16),
         *conv(("NWC", "WIO", "NWC"), stride=(1,), padding="SAME")),
        ("conv3d", (3, 3, 3, 8, 16), (1, 4, 5, 6, 8),
         *conv(("NDHWC", "DHWIO", "NDHWC"), stride=(1, 1, 1), padding="SAME")),
        ("temporal311", (3, 1, 1, 32, 40), (2, 4, 3, 5, 32),
         JQ.temporal_conv311_i8, Q.temporal_conv311_i8),
    ]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_int8_forwards_match_jax(case):
    name, wshape, xshape, jfn, tfn = case
    rng = np.random.default_rng(61)
    w = rng.normal(0, 0.05, wshape).astype(np.float32)
    b = rng.normal(0, 0.1, wshape[-1]).astype(np.float32)
    x = rng.normal(0, 1.0, xshape).astype(np.float32)
    p = JQ.quantize_pytree({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, min_size=0,
                           jit=False)
    ref = jfn(p, jnp.asarray(x))
    m = Q.quantize_module(_layer(name, w, b), min_size=0)
    assert Q.is_w8a8(m) and m.weight_i8.dtype == torch.int8
    np.testing.assert_array_equal(m.weight_i8.numpy(),
                                  convert.jax_to_torch_layout("x.weight_i8",
                                                              np.asarray(p["weight_i8"])))
    with torch.no_grad():
        ours = tfn(m, t(x))
    assert ours.dtype == torch.float32
    assert_close(ours, ref, OP_TOL, name=name)


def test_conv_i8_scale_spans_the_batch():
    """One activation absmax over the whole batch: sample 1, 100x smaller
    than sample 0, is quantized on sample 0's scale (JAX's per-tensor
    scale), not its own."""
    rng = np.random.default_rng(62)
    w = rng.normal(0, 0.05, (3, 3, 8, 8)).astype(np.float32)
    x = rng.normal(0, 1.0, (2, 6, 6, 8)).astype(np.float32)
    x[1] *= 0.01
    p = JQ.quantize_pytree({"weight": jnp.asarray(w)}, min_size=0, jit=False)
    ref = JQ.conv_i8(p, jnp.asarray(x), stride=(1, 1), padding="SAME",
                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    m = Q.quantize_module(_layer("c", w), min_size=0)
    ours = Q.conv_i8(m, t(x)).numpy()
    assert_close(ours, ref, OP_TOL)
    alone = Q.conv_i8(m, t(x[1:])).numpy()
    assert np.abs(alone - ours[1:]).max() > 10 * np.abs(ours[1:] - np.asarray(ref[1:])).max()


@pytest.mark.parametrize("kind", ["linear", "conv2d", "temporal311"])
def test_weight_only_matches_jax(kind):
    rng = np.random.default_rng(63)
    shape = {"linear": (48, 40), "conv2d": (3, 3, 16, 24), "temporal311": (3, 1, 1, 16, 24)}[kind]
    w = rng.normal(0, 0.05, shape).astype(np.float32)
    b = rng.normal(0, 0.1, shape[-1]).astype(np.float32)
    xs = {"linear": (3, 5, 48), "conv2d": (2, 7, 9, 16), "temporal311": (1, 3, 4, 5, 16)}[kind]
    x = rng.normal(0, 1.0, xs).astype(np.float32)
    p = JQ.quantize_pytree({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, min_size=0,
                           mode="w8", jit=False)
    jfn = {"linear": JF.linear, "conv2d": JF.conv2d, "temporal311": JF.conv3d}[kind]
    tfn = {"linear": TF.linear, "conv2d": TF.conv2d, "temporal311": TF.temporal_conv311}[kind]
    m = Q.quantize_module(_layer(kind, w, b), min_size=0, mode="w8")
    assert Q.W8 in m._buffers and not Q.is_float(m)
    with torch.no_grad():
        assert_close(tfn(m, t(x)), jfn(p, jnp.asarray(x)), OP_TOL, name=kind)
        # in bf16 the codes and the scale are each cast before the product
        assert torch.equal(Q.dequantize_weight(m, torch.bfloat16),
                           m.weight_q8.bfloat16() * m.scale.bfloat16().reshape(
                               -1, *[1] * (len(shape) - 1)))


@pytest.fixture(scope="module")
def unet_shapes():
    """The full-width JAX UNet's parameter shapes (jax.eval_shape)."""
    return jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), JU.UNetConfig()))


@pytest.fixture
def jax_selection(monkeypatch, unet_shapes):
    """JAX's quantize_pytree over the full-width UNet's shapes, its
    selection logic run as it is with each selected leaf's quantize_weight
    replaced by zero codes of the leaf's shape (no arrays are made):
    kw -> (tree, {torch name of each quantized weight: its leaf key}, int8
    bytes)."""
    monkeypatch.setattr(JQ, "quantize_weight", lambda w, clip_pct=None: (
        np.broadcast_to(np.int8(0), w.shape), np.zeros(w.shape[-1], np.float32)))

    def select(**kw):
        q = JQ.quantize_pytree(unet_shapes, jit=False, **kw)
        return q, _quantized_leaves(q), JQ.size_report(q)["int8_bytes"]

    return select


def _quantized_leaves(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_quantized_leaves(v, path + (k,)))
        elif k in (Q.W8A8, Q.W8):
            out[".".join(path)] = k
    return out


@pytest.mark.parametrize("which", ["all", "conv", "conv_wide"])
@pytest.mark.parametrize("mode,conv_mode,min_size", [("w8a8", None, None), ("w8", None, 0),
                                                     ("w8a8", "w8", 200000)])
def test_layer_selection_matches_jax(jax_selection, which, mode, conv_mode, min_size):
    kw = dict(which=which, mode=mode, conv_mode=conv_mode, min_size=min_size)
    _, ref, ref_bytes = jax_selection(**kw)
    with torch.device("meta"):
        unet = Q.quantize_module(TU.UNet3D(TU.UNetConfig()), **kw)
    ours = {n: k for n, m in unet.named_modules() for k in (Q.W8A8, Q.W8) if k in m._buffers}
    assert ours == ref and ours
    assert Q.size_report(unet)["int8_bytes"] == ref_bytes
    for n in ours:
        m = unet.get_submodule(n)
        assert not Q.is_float(m) and m.scale.shape == (Q.weight_shape(m)[0],)


def test_conv_w8a8_to_w8_matches_jax(jax_selection):
    tree, n_ref = JQ.conv_w8a8_to_w8(jax_selection()[0])
    with torch.device("meta"):
        unet = Q.quantize_module(TU.UNet3D(TU.UNetConfig()))
    n = Q.conv_w8a8_to_w8(unet)
    assert n == n_ref and n > 0
    assert ({k for k, m in unet.named_modules() if Q.W8 in m._buffers}
            == {k for k, v in _quantized_leaves(tree).items() if v == Q.W8})
    assert Q.conv_w8a8_to_w8(unet) == 0


def test_cast_keeps_int8_and_fp32_scales():
    m = Q.quantize_module(nn.Linear(64, 32), min_size=0)
    m.to(torch.bfloat16)
    assert m.weight_i8.dtype == torch.int8
    assert m.scale.dtype == m.bias.dtype == torch.float32
    assert isinstance(m.bias, nn.Parameter)


@pytest.fixture(scope="module")
def tiny_unets():
    """The tiny UNet's random tree, JAX's quantization of it (min_size 0,
    W8A8 everywhere) and the port's."""
    tree = random_tree(jax.eval_shape(
        lambda: JU.init_unet(jax.random.PRNGKey(0), JU.UNetConfig(**TINY_UNET))), 64)
    qtree = JQ.quantize_pytree(to_jax(tree), min_size=0)
    float_unet = port(TU.UNet3D(TU.UNetConfig(**TINY_UNET)), tree)
    y_float = _port_unet(float_unet, torch.float32)
    return tree, qtree, Q.quantize_module(float_unet, min_size=0), y_float


def test_jax_quantized_tree_loads(tiny_unets):
    """convert.load_tree puts JAX's int8 tree into a module quantize_module
    restructured alike: its int8 buffers stay int8 and equal the port's own
    quantization (codes within 1 and scales within rtol 1e-6 of JAX's
    single-executable conversion, the bound tests/test_quant.py:174-189
    allows it against JAX's eager one)."""
    _, qtree, ours, _ = tiny_unets
    with torch.device("meta"):
        unet = Q.quantize_module(TU.UNet3D(TU.UNetConfig(**TINY_UNET)), min_size=0)
    loaded = convert.load_tree(unet, jax.tree.map(np.asarray, qtree), device="cpu")
    got, want = loaded.state_dict(), ours.state_dict()
    assert got.keys() == want.keys()
    assert sum(v.dtype == torch.int8 for v in got.values()) > 20
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        if v.dtype == torch.int8:
            assert (v.int() - want[k].int()).abs().max() <= 1, k
        else:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)


def _unet_inputs():
    rng = np.random.default_rng(65)
    return (rng.standard_normal((2, 4, 8, 8, 12)).astype(np.float32),
            rng.standard_normal((2, 77 + 4 * 16, 16)).astype(np.float32),
            np.array([999, 421]), np.array([0, 500]), np.array([10, 3]))


def _jax_unet(tree, dtype):
    x, ctx, ts, lab, fs = _unet_inputs()
    return np.asarray(jax.jit(lambda p: JU.unet_apply(
        p, JU.UNetConfig(**TINY_UNET), jnp.asarray(x, dtype), jnp.asarray(ts, jnp.int32),
        jnp.asarray(ctx, dtype), c_label=jnp.asarray(lab, jnp.int32),
        fs=jnp.asarray(fs, jnp.int32)))(tree), np.float32)


def _port_unet(unet, dtype):
    x, ctx, ts, lab, fs = _unet_inputs()
    with torch.no_grad():
        y = unet(t(x).to(dtype), t(ts), t(ctx).to(dtype), c_label=t(lab), fs=t(fs))
    assert y.dtype == dtype
    return y.float().numpy()


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_weight_only_unet_forward_matches_jax(tiny_unets):
    """Weight-only int8 (no activation quantization): the tiny UNet forward
    in fp32 within the slice tolerance."""
    tree = tiny_unets[0]
    ref = _jax_unet(JQ.quantize_pytree(to_jax(tree), min_size=0, mode="w8"), jnp.float32)
    unet = Q.quantize_module(port(TU.UNet3D(TU.UNetConfig(**TINY_UNET)), tree), min_size=0,
                             mode="w8")
    assert_close(_port_unet(unet, torch.float32), ref, SLICE_TOL, SLICE_ATOL, "w8 unet")


def _site_calls(monkeypatch, unet):
    """Record each int8 op call of a forward: (op, layer name, input, keyword
    arguments, output)."""
    names = {id(m): n for n, m in unet.named_modules()}
    calls = []
    for op in ("linear_i8", "conv_i8", "temporal_conv311_i8"):
        def wrapped(m, x, *, _op=op, _orig=getattr(Q, op), **kw):
            y = _orig(m, x, **kw)
            calls.append((_op, names[id(m)], x.clone(), kw, y))
            return y
        monkeypatch.setattr(Q, op, wrapped)
    return calls


def _jax_site(qtree, op, name, x, kw):
    p = qtree
    for k in name.split("."):
        p = p[k]
    x = jnp.asarray(x.float().numpy())
    if op == "linear_i8":
        w = p["weight_i8"]
        return JQ.linear_i8(dict(p, weight_i8=w.reshape(w.shape[-2:])), x)
    if op == "conv_i8":
        return JQ.conv_i8(p, x, stride=(kw["stride"],) * 2, padding=kw["padding"],
                          dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return JQ.temporal_conv311_i8(p, x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantized_unet_forward_matches_jax(tiny_unets, monkeypatch, dtype):
    """W8A8 everywhere. The per-tensor and per-row activation codes turn
    last-bit differences of their inputs into code flips, which the next
    layers carry on: JAX's jitted and eager forwards of this tiny UNet
    differ by 5.6% relative L2, as much as its int8 forward differs from
    its float one (6.2%; measured on the CPU). So the whole forward is held
    as phase 3 of chip_smoke.py holds a path: its relative L2 error against
    JAX's within 1.5x JAX's own int8 error + 5e-3 (JAX's int8 forward
    against the fp32 float forward, the port's, which the slice tolerance
    holds to JAX's in tests/test_torch_model.py); and in fp32 each int8
    op's first site of every (op, arguments, weight rank) equals JAX's op
    on the port's input (1e-6 * max|ref|)."""
    _, qtree, ours, y_float = tiny_unets
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = _jax_unet(qtree, jdt)
    noise = _rel_l2(ref, y_float)
    unet = ours
    if dtype == "bf16":
        unet = TU.UNet3D(TU.UNetConfig(**TINY_UNET))
        Q.quantize_like(unet, ours.state_dict())
        unet.load_state_dict(ours.state_dict())
        unet.to(tdt)
    calls = _site_calls(monkeypatch, unet)
    err = _rel_l2(_port_unet(unet, tdt), ref)
    assert err <= 1.5 * noise + 5e-3, (err, noise)
    assert {c[0] for c in calls} == {"linear_i8", "conv_i8", "temporal_conv311_i8"}
    if dtype == "f32":
        seen = set()
        for op, name, x, kw, y in calls:
            key = (op, str(kw), len(Q.weight_shape(unet.get_submodule(name))))
            if key not in seen:
                seen.add(key)
                assert_close(y, _jax_site(qtree, op, name, x, kw), OP_TOL, name=name)
        assert len(seen) >= 5


@pytest.fixture(scope="module")
def artifacts(scene, tmp_path_factory):
    """A tiny MDM's fp32 state dict, its `quantize` artifacts (W8A8
    everywhere, and W8A8 convs only) and an item list of the scene."""
    tmp = tmp_path_factory.mktemp("quant_apps")
    mdm = TP.tiny()
    from mudg_tpu_torch.models import mdm as TMDM

    src = str(tmp / "src.pt")
    torch.save(TMDM.init_mdm(mdm, torch.Generator().manual_seed(5)).state_dict(), src)
    out = {"src": src, "tmp": tmp, "items": scene_items(scene, tmp / "items.txt", 1)}
    for name, extra in (("all", []), ("conv", ["--which", "conv"])):
        out[name] = str(tmp / f"q_{name}.pt")
        assert TQA.main(["--ckpt", src, "--out", out[name], "--preset", "tiny", "--min_size",
                         "0", "--device", "cpu", *extra]) == 0
    return out


def _load(path, quantize="none", **kw):
    """render's serving MDM from `path` (fp32, CPU)."""
    mdm = TR.load_params(argparse.Namespace(ckpt=path), TP.tiny(), "cpu")
    return TR.prepare_serving_params(mdm, quantize, torch.float32, **kw)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_quantize_artifact_renders_as_quantize_flag(artifacts, tmp_path, monkeypatch):
    """`quantize` -> `render --ckpt`: the int8 buffers load intact, equal to
    `render --quantize int8` of the source, and both renders write the same
    files."""
    art = _load(artifacts["all"])
    flag = _load(artifacts["src"], quantize="int8", min_size=0)
    a, b = art.state_dict(), flag.state_dict()
    assert a.keys() == b.keys()
    assert sum(v.dtype == torch.int8 for v in a.values()) > 20
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    monkeypatch.setenv("MUDG_ALLOW_HASH_TOKENIZER", "1")   # random weights, no BPE table
    outs = []
    for name, extra in (("art", ["--ckpt", artifacts["all"]]),
                        ("flag", ["--ckpt", artifacts["src"], "--quantize", "int8",
                                  "--quantize_min_size", "0"])):
        out = tmp_path / name
        assert TR.main(["--items", artifacts["items"], "--out", str(out), *RENDER,
                        *extra]) == 0
        outs.append(out)
    assert _files(outs[0]) == _files(outs[1]) and _files(outs[0])
    assert any(n.endswith(".png") for n in _files(outs[0]))
    for name in _files(outs[0]):
        assert (outs[0] / name).read_bytes() == (outs[1] / name).read_bytes(), name


def test_seq_parallel_demotes_int8_convs(artifacts, capsys):
    """Under sequence parallelism an artifact's W8A8 convs are demoted to
    weight-only and `--quantize int8-conv` quantizes them weight-only: the
    same layers, buffers and codes either way."""
    demoted = _load(artifacts["conv"], sharded=True)
    assert "int8 conv layers demoted to weight-only" in capsys.readouterr().out
    direct = _load(artifacts["src"], quantize="int8-conv", min_size=0, sharded=True)
    a, b = demoted.state_dict(), direct.state_dict()
    assert a.keys() == b.keys() and any(k.endswith(Q.W8) for k in a)
    assert not any(k.endswith(Q.W8A8) for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_render_quantized_seq_parallel_at_2_ranks(artifacts, monkeypatch):
    """`render --quantize int8-conv --seq_parallel` and `render --ckpt
    <int8-conv artifact> --seq_parallel` at 2 gloo ranks write what one
    process writes from the artifact with its convs demoted (images within
    one level, depth within 1e-3, as tests/test_torch_parallel_apps.py)."""
    import cv2

    monkeypatch.setenv("MUDG_ALLOW_HASH_TOKENIZER", "1")   # random weights, no BPE table
    tmp = artifacts["tmp"]
    mdm = TR.load_params(argparse.Namespace(ckpt=artifacts["conv"]), TP.tiny(), "cpu")
    assert Q.conv_w8a8_to_w8(mdm.unet) > 0
    demoted = str(tmp / "q_conv_w8.pt")
    torch.save(mdm.state_dict(), demoted)
    one = tmp / "sp_one"
    assert TR.main(["--items", artifacts["items"], "--out", str(one), *RENDER,
                    "--ckpt", demoted]) == 0
    runs = {"flag": ["--ckpt", artifacts["src"], "--quantize", "int8-conv",
                     "--quantize_min_size", "0"],
            "art": ["--ckpt", artifacts["conv"]]}
    argv = [["render", "--items", artifacts["items"], "--out", str(tmp / f"sp_{k}"), *RENDER,
             *v, "--seq_parallel"] for k, v in runs.items()]
    for r0, r1 in zip(*R.spawn(R.run_apps, 2, tmp, argv)):
        assert r0["rc"] in (0, None) and r1["rc"] in (0, None), (r0, r1)
        assert r0["writes"] > 0 and r1["writes"] == 0, (r0, r1)
    for k in runs:
        out = tmp / f"sp_{k}"
        assert _files(out) == _files(one) and _files(one)
        for name in _files(one):
            a, b = str(out / name), str(one / name)
            if name.endswith(".npy"):
                np.testing.assert_allclose(np.load(a), np.load(b), atol=1e-3, rtol=0)
            elif name.endswith(".png"):
                assert np.abs(cv2.imread(a).astype(int) - cv2.imread(b).astype(int)).max() <= 1
