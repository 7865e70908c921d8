"""The port's inference apps against the JAX apps on the CPU (tiny preset,
fp32): `render_items` over two autoregressive windows of the synthetic
scene beside JAX `render_items` (2-point CFG, 3-point CFG, DPM-Solver++,
and one batch-2 call per task with task_serial), the files both write, the
`serve` spool daemon, and the flags that wait for later slices.

Both samplers start each window from the noise JAX `sample` draws from the
key the JAX loop splits for it (render_infer.py:274,299), which task_serial
passes to each of its three calls (:305-311); the port is given it as x_T
through its sampler closure. DDIM runs at eta 0, so no step noise is
drawn. Tolerance: 2e-3 * max|ref| + 5e-5, the fp32 compositions'
(tests/test_torch_mdm1024.py).
"""
from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudg_tpu.apps import render_infer as JR
from mudg_tpu.models import mdm as JMDM
from mudg_tpu.models import presets as JP
from mudg_tpu_torch import convert
from mudg_tpu_torch.apps import render_infer as TR
from mudg_tpu_torch.apps import serve as TS
from mudg_tpu_torch.models import mdm as TMDM
from mudg_tpu_torch.models import presets as TP
from test_torch_util import assert_close, random_tree, to_jax

TOL, ATOL = 2e-3, 5e-5
H, W, VL, STEPS, SEED = 32, 64, 4, 2, 123
CASES = {"cfg2": {}, "cfg3": {"multiple_cond_cfg": True, "cfg_img": 3.0},
         "dpmpp": {"sampler": "dpmpp"}, "serial": {"task_serial": True}}
SIZE = ["--preset", "tiny", "--height", str(H), "--width", str(W), "--video_length", str(VL)]


def scene_items(scene, path, n):
    """An item list of `n` copies of the scene's one camera window, as
    tests/test_apps.py writes it."""
    from mudg_tpu.apps.make_conditions import render_scene_conditions
    from mudg_tpu.data.waymo import write_items

    render_scene_conditions(scene, ("camera_FRONT",))
    cam = "camera_FRONT"
    item = {
        "frames": [f"{i:08d}.jpg" for i in range(4)],
        "dense_color_base": os.path.join(scene, "images", cam),
        "sparse_color_base": os.path.join(scene, "sparse", cam),
        "dense_semantic_base": os.path.join(scene, "semantic_dense", cam),
        "dense_depth_base": os.path.join(scene, "six_frames_depth", cam),
        "sparse_depth_base": os.path.join(scene, "depth", cam),
    }
    write_items(str(path), [item] * n)
    return str(path)


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def setup(scene, tmp_path_factory):
    """The tiny tree, the port's MDM loaded from it, token ids, the items
    (3 items: windows at items 0 and 2)."""
    cfg = JP.tiny()
    tree = random_tree(jax.eval_shape(lambda: JMDM.init_mdm(jax.random.PRNGKey(0), cfg)), 60)
    mdm = convert.load_tree(TMDM.MDM(TP.tiny()), tree, device="cpu").eval()
    rng = np.random.default_rng(61)
    vocab = cfg.clip_text.vocab_size
    tokens = rng.integers(0, vocab, (3, 77)).astype(np.int32)
    null_tokens = rng.integers(0, vocab, (77,)).astype(np.int32)
    items_path = scene_items(scene, tmp_path_factory.mktemp("items") / "items.txt", 3)
    return cfg, tree, mdm, tokens, null_tokens, items_path


@pytest.fixture(scope="module", params=list(CASES))
def rendered(request, setup, tmp_path_factory):
    """Both apps' render_items on the same tree, items and tokens: JAX's
    sampler jitted once; the port given each window's JAX start noise."""
    from mudg_tpu.data.waymo import read_items

    cfg, tree, mdm, tokens, null_tokens, items_path = setup
    kw = dict(CASES[request.param])
    serial = kw.pop("task_serial", False)
    calls = 3 if serial else 1   # sampler calls per window
    items = read_items(items_path)
    out = tmp_path_factory.mktemp(request.param)
    jdir, tdir = str(out / "jax"), str(out / "port")

    jfn = JR.build_sampler(cfg, steps=STEPS, eta=0.0, dtype=jnp.float32, **kw)
    jouts = []

    def jax_sample(*a):
        o = jfn(*a)
        jouts.append(np.asarray(o))
        return o

    JR.render_items(to_jax(tree), jax_sample, items, jdir, tokens=jnp.asarray(tokens),
                    null_tokens=jnp.asarray(null_tokens), video_length=VL, resolution=(H, W),
                    task_serial=serial, max_windows=2, seed=SEED)

    # each window's x_T: the key the JAX loop splits, then ddim/dpmpp_sample's
    # split, the same for each of the window's calls
    rng, x_ts = jax.random.PRNGKey(SEED), []
    for _ in range(len(jouts) // calls):
        rng, key = jax.random.split(rng)
        x_ts += [np.array(jax.random.normal(jax.random.split(key)[1],
                                              (3 // calls, VL, H // 2, W // 2, 4),
                                              jnp.float32))] * calls
    tfn = TR.build_sampler(steps=STEPS, eta=0.0, dtype=torch.float32, **kw)
    touts = []

    def port_sample(*a, x_T=None):
        assert x_T is None
        o = tfn(*a, x_T=torch.from_numpy(x_ts[len(touts)]))
        touts.append(o.numpy())
        return o

    res = TR.render_items(mdm, port_sample, items, tdir, tokens=torch.from_numpy(tokens).long(),
                          null_tokens=torch.from_numpy(null_tokens).long(), video_length=VL,
                          resolution=(H, W), task_serial=serial, max_windows=2, seed=SEED)
    return request.param, jouts, touts, jdir, tdir, res, calls


def test_render_items_matches_jax(rendered):
    """Two autoregressive windows (the second carries the first's color):
    each sampler call's (3, T, H, W, 3) window, or (1, T, H, W, 3) task with
    task_serial, within the tolerance of JAX's."""
    name, jouts, touts, _, _, res, calls = rendered
    assert res["windows"] == 2 and len(jouts) == len(touts) == 2 * calls
    for i, (j, o) in enumerate(zip(jouts, touts)):
        assert o.shape == (3 // calls, VL, H, W, 3)
        assert float(np.abs(j).max()) > 0.05   # the clip carries signal
        assert_close(o, j, TOL, ATOL, f"{name} window {i}")


def test_render_items_writes_the_jax_files(rendered):
    """The same file names (frames, GT, depth .npy, compare videos) and the
    depth maps within the tolerance."""
    name, _, _, jdir, tdir, _, _ = rendered
    names = files(jdir)
    assert names == files(tdir)
    assert "compare_color.mp4" in names and "virtual_depth/depth_re_5.npy" in names
    depths = [n for n in names if n.endswith(".npy")]
    assert len(depths) == VL + VL // 2   # two windows, VL // 2 frames apart
    for n in depths:
        assert_close(np.load(os.path.join(tdir, n)), np.load(os.path.join(jdir, n)),
                     TOL, ATOL, f"{name} {n}")


def test_serve_spool_daemon(scene, tmp_path):
    """apps/serve over a spool, as tests/test_apps.py drives the JAX daemon
    (without int8 and sequence parallelism): two requests oldest first give
    .done with their metrics and outputs, a malformed one .err, and no
    .json or .active is left."""
    items_path = scene_items(scene, tmp_path / "items.txt", 2)
    spool = tmp_path / "spool"
    spool.mkdir()
    reqs = []
    for i, extra in enumerate([{}, {"prompt": "night driving", "seed": 7, "task_serial": True}]):
        req = {"items": items_path, "out": str(tmp_path / f"out{i}"), "max_windows": 1, **extra}
        path = spool / f"req{i}.json"
        path.write_text(json.dumps(req))
        os.utime(path, (time.time() - 10 + i, time.time() - 10 + i))
        reqs.append(req)
    (spool / "bad.json").write_text("{not json")
    os.utime(spool / "bad.json", (time.time(), time.time()))

    rc = TS.main(["--spool", str(spool), *SIZE, "--steps", "1", "--max_requests", "3",
                  "--dtype", "f32", "--device", "cpu"])
    assert rc == 0
    for i in range(2):
        done = json.loads((spool / f"req{i}.done").read_text())
        assert done["windows"] == 1 and done["request"] == f"req{i}.json"
        for task in ("color", "depth", "semantic"):
            assert os.path.exists(os.path.join(reqs[i]["out"], f"virtual_{task}",
                                               f"{task}_re_0.png"))
    assert "JSONDecodeError" in (spool / "bad.err").read_text()
    assert not list(spool.glob("*.json")) and not list(spool.glob("*.active"))


@pytest.mark.parametrize("flags,rc", [(["--quantize", "int8"], 0),
                                     (["--quantize_min_size", "1000"], 0),
                                     (["--seq_parallel"], 0)])
def test_render_flags_of_later_slices(scene, tmp_path, flags, rc):
    """The flags of the later slices run the app: --quantize int8 and
    --quantize_min_size (the int8 slice; tests/test_torch_quant.py holds
    what they compute), and --seq_parallel on one device, ignored as the
    JAX app on one device ignores it."""
    args = ["--items", scene_items(scene, tmp_path / "items.txt", 1), "--out",
            str(tmp_path / "out"), *SIZE, "--steps", "1", "--max_windows", "1", "--dtype",
            "f32", "--device", "cpu", *flags]
    assert TR.main(args) == rc
    assert os.path.exists(tmp_path / "out" / "virtual_color" / "color_re_0.png")


def test_task_serial_calls_share_the_window_noise():
    """With task_serial, render_windows gives the three calls of a window
    the generator in one state, as the JAX loop gives them one key; the
    next window draws anew. The sampler here draws its x_T from the
    generator and returns it as the clip."""
    rng = np.random.default_rng(62)
    windows = [{"sparse_frames": rng.uniform(-1, 1, (VL, 8, 8, 3)).astype(np.float32),
                "frame0": rng.uniform(-1, 1, (8, 8, 3)).astype(np.float32),
                "sparse_depth": rng.uniform(-1, 1, (VL, 8, 8, 3)).astype(np.float32),
                "class_labels": np.array([0, 500, 1], np.int32)} for _ in range(2)]

    def draw(mdm, tokens, null_tokens, generator, sparse, depth, labels):
        return torch.randn(sparse.shape, generator=generator)

    gen = torch.Generator().manual_seed(SEED)
    outs = [o for _, _, o in TR.render_windows(
        None, draw, windows, tokens=torch.zeros(3, 77, dtype=torch.long),
        null_tokens=torch.zeros(77, dtype=torch.long), video_length=VL, generator=gen,
        task_serial=True)]
    for out in outs:
        assert out.shape == (3, VL, 8, 8, 3)
        np.testing.assert_array_equal(out[1], out[0])
        np.testing.assert_array_equal(out[2], out[0])
    assert not np.array_equal(outs[0][0], outs[1][0])


def test_render_runs_on_the_card_by_default(scene, tmp_path):
    """Without --device the app takes the card: where torch has no CUDA it
    raises instead of falling back to the CPU."""
    args = ["--items", scene_items(scene, tmp_path / "items.txt", 1), "--out",
            str(tmp_path / "out"), *SIZE, "--steps", "1"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        TR.main(args)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
@pytest.mark.parametrize("steps", [1, 2])
def test_sampler_constants_at_few_steps_match_jax(sampler, steps):
    """The sampler constants at the step counts the app tests run (one step
    is a length-1 schedule) equal JAX's, field by field."""
    from mudg_tpu.diffusion import ddim as JDDIM
    from mudg_tpu.diffusion import dpm as JDPM
    from mudg_tpu_torch.diffusion import ddim as TDDIM
    from mudg_tpu_torch.diffusion import dpm as TDPM

    sched = TP.mdm512().schedule()
    if sampler == "ddim":
        ours = TDDIM.make_ddim_constants(sched, steps, eta=1.0)
        ref = JDDIM.make_ddim_constants(JP.mdm512().schedule(), steps, eta=1.0)
    else:
        ours = TDPM.make_dpmpp_constants(sched, steps)
        ref = JDPM.make_dpmpp_constants(JP.mdm512().schedule(), steps)
    for name, r in ref._asdict().items():
        o = getattr(ours, name)
        assert o.shape == (steps,), name
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, err_msg=name)
