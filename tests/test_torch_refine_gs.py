"""The port's 3DGS refinement (gs/train.py, gs/io.py, apps/refine_gs.py)
against the JAX package, f32 on the CPU, the same seeded numpy state fed to
both (`convert.gaussians_from_arrays`).

Tolerances:
  * SSIM and the loss of a train step: 1e-5 relative (f32 op order);
  * every gradient of a train step (read from Adam's first moment, mu / 0.1):
    2e-3 * max|ref| + 1e-8, the tile rasterizer's gradient tolerance
    (tests/test_tile_raster.py:94-96);
  * parameters after several steps: within 3 learning rates of the field.
    Adam's first step is about -lr * sign(g), so a gradient at noise level
    (quats ~1e-10 here) may flip sign between the two and move that entry
    by 2 lr the other way;
  * densify_and_prune: bit for bit (the same host numpy code and draws);
  * the PLY files: bit for bit, both ways;
  * refine-gs: the same active count and loss history within 2e-2
    relative; holdout PSNR within 0.5 dB (30 steps of two f32
    implementations on a 32x48 render).
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudg_tpu.gs import gaussians as JG
from mudg_tpu.gs import io as JIO
from mudg_tpu.gs import train as JT
from mudg_tpu_torch import convert
from mudg_tpu_torch.gs import io as TIO
from mudg_tpu_torch.gs import train as TT
from test_torch_util import assert_close, t

JAX_LABEL = {"log_scales": "scales"}


@pytest.fixture(autouse=True)
def lex_sort(monkeypatch):
    monkeypatch.setenv("MUDG_GS_SORT", "lex")


def fields(n=60, seed=0, capacity=80, sh_k=3):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(0, 1.0, (n, 3)) + [0, 0, 5]).astype(np.float32)
    rgb = rng.random((n, 3)).astype(np.float32)
    g = JG.init_from_points(jnp.asarray(xyz), jnp.asarray(rgb), capacity=capacity,
                            opacity=0.3)
    f = {k: np.array(getattr(g, k)) for k in g._fields if getattr(g, k) is not None}
    f["log_scales"] += rng.normal(0, 0.3, f["log_scales"].shape).astype(np.float32)
    f["quats"] += rng.normal(0, 0.2, f["quats"].shape).astype(np.float32)
    if sh_k:
        f["sh"] = rng.normal(0, 0.1, (capacity, sh_k, 3)).astype(np.float32)
    return f


def views(n=3, hw=(32, 32), seed=1, sem=False):
    rng = np.random.default_rng(seed)
    K = np.array([[30.0, 0, hw[1] / 2], [0, 30.0, hw[0] / 2], [0, 0, 1]], np.float32)
    out = []
    for i in range(n):
        w2c = np.eye(4, dtype=np.float32)
        # the inactive slots sit at the origin: keep them off the camera
        # plane, where the JAX capped path's covariance overflows to NaN
        w2c[:3, 3] = [0.2 * i - 0.2, 0.1 * i, 0.3 * i + 0.5]
        v = {"K": K, "w2c": w2c, "rgb": rng.random((*hw, 3)).astype(np.float32),
             "depth": rng.uniform(3, 7, hw).astype(np.float32),
             "depth_mask": (rng.random(hw) < 0.5).astype(np.float32)}
        if sem:
            v["sem_ids"] = rng.integers(0, 5, hw).astype(np.int32)
        out.append(v)
    return out


def jax_mu(state, k):
    label = JAX_LABEL.get(k, k)
    return np.asarray(state.opt_state.inner_states[label].inner_state[0].mu[k])


def port_state(jstate, tc, n_views=0):
    """The port's train state from a JAX one (gaussians and accumulators)."""
    g = jax.device_get(jstate.gaussians)
    gt = convert.gaussians_from_arrays({k: getattr(g, k) for k in g._fields}, device="cpu")
    return TT.init_state(gt, tc, n_views)._replace(
        grad_accum=t(np.asarray(jstate.grad_accum)),
        grad_count=t(np.asarray(jstate.grad_count)), step=int(jstate.step))


def configs(**kw):
    """The JAX tile path (explicit budget, drop-free here) and the port's."""
    return JT.GSConfig(backend="pallas", max_pairs=8192, **kw), TT.GSConfig(backend="pallas", **kw)


def test_ssim_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.random((24, 40, 3)).astype(np.float32), rng.random((24, 40, 3)).astype(np.float32)
    b = (0.7 * a + 0.3 * b).astype(np.float32)
    assert_close(TT.ssim(t(a), t(b)).reshape(1), np.asarray(JT.ssim(a, b)).reshape(1), 1e-5,
                 name="ssim")
    assert abs(float(TT.ssim(t(a), t(a))) - 1.0) < 1e-5


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_train_step_loss_gradients_and_params_match_jax(backend):
    """One step: loss and every gradient tight (SH, appearance, depth and a
    semantic field on); then four more steps: parameters within 3 lr."""
    jc, tc = configs(sh_degree=1, appearance=True, semantic_weight=0.5, semantic_classes=5)
    if backend == "xla":
        jc = JT.GSConfig(**{**jc.__dict__, "backend": "xla"})
        tc = TT.GSConfig(**{**tc.__dict__, "backend": "xla"})
    f = fields(sh_k=3)
    f["sem"] = np.random.default_rng(3).normal(0, 1, (80, 5)).astype(np.float32)
    vs = views(sem=True)
    js = JT.init_state(JG.Gaussians(**{k: jnp.asarray(v) for k, v in f.items()}), jc,
                       n_views=3)
    ts = TT.init_state(convert.gaussians_from_arrays(f, device="cpu"), tc, n_views=3)
    jstep = JT.make_gs_train_step(jc, width=32, height=32)
    tstep = TT.make_gs_train_step(tc, width=32, height=32)
    for i, vi in enumerate([1, 0, 2, 1, 2]):
        v = vs[vi]
        js, jm = jstep(js, *(jnp.asarray(v[k]) for k in ("K", "w2c", "rgb", "depth",
                                                          "depth_mask")),
                       None, None, jnp.asarray(v["sem_ids"]), jnp.asarray(vi, jnp.int32))
        ts, tm = tstep(ts, *(t(v[k]) for k in ("K", "w2c", "rgb", "depth", "depth_mask")),
                       None, None, t(v["sem_ids"]), vi)
        if i == 0:
            assert_close(tm["loss"].reshape(1), np.asarray(jm["loss"]).reshape(1), 1e-5,
                         name="loss")
            for k in ts.opt_state["mu"]:
                assert_close(ts.opt_state["mu"][k] / 0.1, jax_mu(js, k) / 0.1, 2e-3, 1e-8,
                             name=f"d{k}")
            assert_close(ts.grad_accum, np.asarray(js.grad_accum), 2e-3, 1e-8, "grad_accum")
    params = dict(TT._train_params(ts))
    jparams = dict(JT._train_params(js))
    for k, p in params.items():
        lr = getattr(tc, TT._LR_FIELD[k])
        assert_close(p, np.asarray(jparams[k]), 0.0, 3 * lr, name=k)
    # the appearance of view 0, sampled once, moved; all views' rows stayed sane
    assert float((params["appearance"][0] - torch.cat([torch.eye(3), torch.zeros(3, 1)],
                                                      -1)).abs().max()) > 0


def _densify_state(seed=0):
    f = fields(n=60, capacity=80, seed=seed, sh_k=8)
    rng = np.random.default_rng(seed + 10)
    f["opacity"][:60] = rng.normal(-3, 2, 60).astype(np.float32)   # some prunes
    f["log_scales"][:60] = rng.normal(-3.2, 0.8, (60, 3)).astype(np.float32)   # clone + split
    f["group"] = rng.integers(0, 3, 80).astype(np.int32)
    jc, tc = configs(sh_degree=2)
    js = JT.init_state(JG.Gaussians(**{k: jnp.asarray(v) for k, v in f.items()}), jc)
    js = js._replace(grad_accum=jnp.asarray(rng.random(80).astype(np.float32) * 2e-3),
                     grad_count=jnp.asarray(rng.integers(1, 5, 80).astype(np.float32)),
                     step=jnp.asarray(37, jnp.int32))
    return js, port_state(js, tc), jc, tc


def test_densify_and_prune_matches_jax_bit_for_bit():
    js, ts, jc, tc = _densify_state()
    jout = JT.densify_and_prune(js, jc)
    tout = TT.densify_and_prune(ts, tc)
    jg = jax.device_get(jout.gaussians)
    n_active = int(np.asarray(jg.active).sum())
    assert n_active != int(np.asarray(js.gaussians.active).sum())   # something happened
    for k in jg._fields:
        a, b = getattr(tout.gaussians, k), getattr(jg, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    assert float(tout.grad_accum.abs().sum()) == 0 and tout.opt_state["count"] == 0


def test_fit_scene_with_densify_matches_jax():
    """10 steps with densify_every=5 at 32x32 on the tile path: the view draws,
    the loss history and the active count agree."""
    f = fields(n=60, capacity=90, sh_k=0)
    vs = views(n=3)
    for v in vs:
        del v["depth"], v["depth_mask"]
    jc, tc = configs(densify_every=5, densify_grad_thresh=1e-5)
    jstate, jhist = JT.fit_scene(JG.Gaussians(**{k: jnp.asarray(v) for k, v in f.items()}),
                                 [{k: jnp.asarray(a) for k, a in v.items()} for v in vs], jc,
                                 width=32, height=32, steps=10, log_every=2, seed=3)
    tstate, thist = TT.fit_scene(convert.gaussians_from_arrays(f, device="cpu"),
                                 [{k: t(a) for k, a in v.items()} for v in vs], tc,
                                 width=32, height=32, steps=10, log_every=2, seed=3)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist]
    assert_close([h["loss"] for h in thist], [h["loss"] for h in jhist], 2e-3, name="history")
    assert int(tstate.gaussians.active.sum()) == int(np.asarray(jstate.gaussians.active).sum())
    assert int(tstate.gaussians.active.sum()) > 60   # densify cloned or split
    assert tstate.step == int(jstate.step) == 10


def test_ply_round_trip_both_ways(tmp_path):
    f = fields(sh_k=15)
    gj = JG.Gaussians(**{k: jnp.asarray(v) for k, v in f.items()})
    gt = convert.gaussians_from_arrays(f, device="cpu")
    pj, pt = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    assert JIO.save_gaussians_ply(pj, gj) == TIO.save_gaussians_ply(pt, gt) == 60
    assert open(pj, "rb").read() == open(pt, "rb").read()
    a, b = TIO.load_gaussians_ply(pj), JIO.load_gaussians_ply(pt)
    for k in ("means", "log_scales", "quats", "opacity", "colors", "sh", "active"):
        np.testing.assert_array_equal(getattr(a, k).numpy(), np.asarray(getattr(b, k)), k)
    for k in ("means", "log_scales", "quats", "opacity", "sh"):   # the 60 active slots
        np.testing.assert_array_equal(getattr(a, k).numpy(), f[k][:60], k)


def test_load_tree_defaults_to_the_card():
    """A meta-device module is materialised on the card unless the caller
    names a device: without CUDA that is an error, not a CPU module."""
    tree = {"weight": np.ones((3, 2), np.float32), "bias": np.zeros(2, np.float32)}
    with torch.device("meta"):
        lin = torch.nn.Linear(3, 2)
    with pytest.raises((AssertionError, RuntimeError)):
        convert.load_tree(lin, tree)
    assert convert.load_tree(lin, tree, device="cpu").weight.device.type == "cpu"


def test_gaussians_from_arrays_dtypes():
    f = fields(sh_k=0)
    f["group"] = np.arange(80, dtype=np.int64) % 3
    g = convert.gaussians_from_arrays(f, device="cpu")
    assert g.active.dtype == torch.bool and g.group.dtype == torch.int32
    assert g.means.dtype == torch.float32 and g.sh is None and g.sem is None


def test_cli_mirrors_the_jax_commands():
    from mudg_tpu_torch.__main__ import main

    assert main(["preprocess", "--help"]) == 2
    assert main(["bench"]) == 2
    assert main(["nope"]) == 2
    for cmd in ("refine-gs", "render-infer", "serve", "eval", "eval-nvs", "segment", "densify"):
        r = subprocess.run([sys.executable, "-m", "mudg_tpu_torch", cmd, "--help"],
                           capture_output=True, text=True, timeout=120,
                           cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert r.returncode == 0 and "--device" in r.stdout, (cmd, r.stderr)


APP_ARGS = ["--height", "32", "--width", "48", "--steps", "30", "--capacity", "4096",
            "--limit_frames", "4", "--holdout_every", "4", "--render_virtual"]


def test_refine_gs_main_beside_the_jax_app(scene, tmp_path):
    """The app on the synthetic scene with tests/test_apps.py's arguments on
    the capped path (the JAX app's CPU default), metrics.json beside the
    JAX app's; then the tile path with every option the port's default
    path does not cover."""
    from mudg_tpu.apps import refine_gs as japp
    from mudg_tpu_torch.apps import refine_gs as tapp

    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    japp.main(["--scene", scene, "--out", jd, *APP_ARGS, "--raster_backend", "xla"])
    tapp.main(["--scene", scene, "--out", td, *APP_ARGS, "--raster_backend", "xla",
               "--device", "cpu"])
    jm, tm = (json.load(open(os.path.join(d, "metrics.json"))) for d in (jd, td))
    assert tm["n_gaussians_active"] == jm["n_gaussians_active"] > 100
    assert_close([h["loss"] for h in tm["history"]], [h["loss"] for h in jm["history"]], 2e-2,
                 name="history")
    assert abs(tm["holdout_psnr_mean"] - jm["holdout_psnr_mean"]) < 0.5
    assert tm["dropped_renders"] == [] and tm["holdout_semantic_acc"] is None
    for rel in ("renders/nv_0000.png", "gaussians.pkl", "gaussians.ply", "virtual_left.mp4",
                "virtual_right.mp4", "virtual_renders/left/nv_0000.png"):
        assert os.path.exists(os.path.join(td, rel)), rel
    jp, tp = (pickle.load(open(os.path.join(d, "gaussians.pkl"), "rb")) for d in (jd, td))
    assert set(jp) == set(tp) and all(tp[k].dtype == jp[k].dtype for k in jp)

    # the tile path (the default backend) with the other options, and a warm start
    od = str(tmp_path / "opts")
    tapp.main(["--scene", scene, "--out", od, "--height", "32", "--width", "48", "--steps",
               "6", "--capacity", "4096", "--limit_frames", "4", "--holdout_every", "2",
               "--dynamic", "--semantic", "--appearance", "--sh_degree", "1",
               "--device", "cpu"])
    om = json.load(open(os.path.join(od, "metrics.json")))
    assert np.isfinite(om["holdout_psnr_mean"]) and om["holdout_semantic_acc"] is not None
    assert os.path.exists(os.path.join(od, "renders", "sem_0000.png"))
    op = pickle.load(open(os.path.join(od, "gaussians.pkl"), "rb"))
    assert {"sh", "sem", "group"} <= set(op) and op["group"].max() == 1
    wd = str(tmp_path / "warm")
    tapp.main(["--scene", scene, "--out", wd, "--height", "32", "--width", "48", "--steps",
               "4", "--capacity", "4096", "--limit_frames", "4", "--holdout_every", "4",
               "--init_gaussians", os.path.join(td, "gaussians.ply"), "--device", "cpu"])
    wm = json.load(open(os.path.join(wd, "metrics.json")))
    assert wm["n_gaussians_active"] == tm["n_gaussians_active"]
    assert np.isfinite(wm["holdout_psnr_mean"])


def test_max_pairs_default_and_truncation_match_jax(capsys):
    """`GSConfig().max_pairs` is JAX's 1 << 21, and the tile rasterizer
    takes it as its budget. Under a budget a view overflows, both packages
    drop the same pairs (loss history within 2e-3, as
    test_fit_scene_with_densify_matches_jax) and `fit_scene` warns on the
    same steps."""
    assert TT.GSConfig().max_pairs == JT.GSConfig().max_pairs == 1 << 21
    assert TT.pick_raster(TT.GSConfig(), 32, 32).keywords["max_pairs"] == 1 << 21
    f = fields(n=60, capacity=80, sh_k=0)
    vs = views(n=3)
    for v in vs:
        del v["depth"], v["depth_mask"]
    jc = JT.GSConfig(backend="pallas", max_pairs=96)
    tc = TT.GSConfig(backend="pallas", max_pairs=96)
    jstate, jhist = JT.fit_scene(JG.Gaussians(**{k: jnp.asarray(v) for k, v in f.items()}),
                                 [{k: jnp.asarray(a) for k, a in v.items()} for v in vs], jc,
                                 width=32, height=32, steps=4, log_every=1, seed=3)
    jerr = capsys.readouterr().err
    dropped = []
    tstate, thist = TT.fit_scene(convert.gaussians_from_arrays(f, device="cpu"),
                                 [{k: t(a) for k, a in v.items()} for v in vs], tc,
                                 width=32, height=32, steps=4, log_every=1, seed=3,
                                 on_step=lambda i, s, m: dropped.append(m["n_dropped"]))
    terr = capsys.readouterr().err
    assert all(d > 0 for d in dropped)

    def warned(err):
        return [line.split(":")[0] for line in err.splitlines()
                if line.startswith("# gs.fit_scene step")]
    assert warned(terr) == warned(jerr) == [f"# gs.fit_scene step {i}" for i in range(1, 5)]
    assert_close([h["loss"] for h in thist], [h["loss"] for h in jhist], 2e-3, name="history")
