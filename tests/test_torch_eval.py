"""The port's metrics, depth tools, LPIPS and eval app against the JAX package,
on the CPU.

- PSNR, the depth metrics, mIoU and video PSNR bit for bit (numpy on both
  sides); SSIM (`gs/train.ssim`) within the fp32 tolerance.
- `data/depth_tools`: align_depth, fill_sky, clamp_metric,
  densify_classical (OpenCV's path and numpy's) and densify_depth_map, bit
  for bit.
- LPIPS at 64x64 with `init_lpips` weights against JAX's, and `load_lpips`
  with the `lpips` package's layout and a torchvision AlexNet without heads
  (uniform heads), each against JAX's `load_lpips`.
- The eval app's three tasks (color with LPIPS, depth, semantic) against
  JAX's app: the same per-frame rows and summary (SSIM and LPIPS within one
  step of the 4-digit rounding).
"""
from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudg_tpu.apps import eval_nvs as JAPP
from mudg_tpu.data import depth_tools as JDT
from mudg_tpu.utils import lpips as JLP
from mudg_tpu.utils import media as JM
from mudg_tpu.utils import metrics as JMET
from mudg_tpu_torch.apps import eval_nvs as TAPP
from mudg_tpu_torch.data import depth_tools as TDT
from mudg_tpu_torch.utils import lpips as TLP
from mudg_tpu_torch.utils import media as TM
from mudg_tpu_torch.utils import metrics as TMET
from test_torch_util import assert_close, t

TOL = 1e-4   # tests/test_reference_oracle.py:46-53's fp32 tolerance


def test_numpy_metrics_bit_for_bit():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(-1, 1, (2, 3, 24, 32, 3))
    assert TMET.psnr(a, b) == JMET.psnr(a, b)
    assert TMET.psnr(a, a) == JMET.psnr(a, a) == float("inf")
    assert TMET.video_psnr(a, b) == JMET.video_psnr(a, b)
    gt = np.where(rng.uniform(size=(24, 32)) < 0.7, rng.uniform(1, 80, (24, 32)), 0.0)
    pred = gt * rng.uniform(0.8, 1.3, gt.shape) + rng.uniform(0, 1, gt.shape)
    mask = rng.uniform(size=gt.shape) < 0.8
    for m in (None, mask, np.zeros_like(mask)):
        assert TMET.depth_metrics(pred, gt, m) == JMET.depth_metrics(pred, gt, m)
    ids_a, ids_b = rng.integers(0, 19, (2, 24, 32))
    ids_b[ids_b == 3] = 4
    assert TMET.miou(ids_a, ids_b, 19) == JMET.miou(ids_a, ids_b, 19)


def test_ssim_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (40, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ours, ref = TMET.ssim(a, b), JMET.ssim(a, b)
    assert abs(ours - ref) <= TOL * abs(ref)
    assert TMET.ssim(a, a) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("frac", [0.2, 0.01])
def test_depth_tools_bit_for_bit(monkeypatch, frac):
    rng = np.random.default_rng(2)
    sparse = np.where(rng.uniform(size=(30, 40)) < frac, rng.uniform(2, 60, (30, 40)), 0)
    sparse = sparse.astype(np.float32)
    sem = rng.integers(0, 19, sparse.shape)
    pred = rng.uniform(0, 1, sparse.shape).astype(np.float32)
    for ours, ref in ((TDT.align_depth(pred, sparse), JDT.align_depth(pred, sparse)),
                      (TDT.align_depth(pred, sparse, sem > 5), JDT.align_depth(pred, sparse, sem > 5))):
        np.testing.assert_array_equal(ours[0], ref[0])
        assert ours[1] == ref[1]
    np.testing.assert_array_equal(TDT.fill_sky(pred, sem), JDT.fill_sky(pred, sem))
    np.testing.assert_array_equal(TDT.clamp_metric(sparse * 3), JDT.clamp_metric(sparse * 3))
    for cv2_present in (True, False):
        with monkeypatch.context() as mp:
            if not cv2_present:
                mp.setitem(sys.modules, "cv2", None)   # `import cv2` raises ImportError
            dense = TDT.densify_classical(sparse)
            np.testing.assert_array_equal(dense, JDT.densify_classical(sparse))
            for p in (None, lambda s: s * 0.5 + 1.0):
                np.testing.assert_array_equal(TDT.densify_depth_map(sparse, sem, p),
                                              JDT.densify_depth_map(sparse, sem, p))
        assert dense.dtype == np.float32 and (dense > 0).all()
    np.testing.assert_array_equal(TDT.densify_classical(np.zeros((4, 4), np.float32)),
                                  np.zeros((4, 4), np.float32))


def _port_lpips(params):
    """JAX's LPIPS tree (HWIO convs, lins) in the port's module."""
    sd = {}
    for idx, p in params["features"].items():
        sd[f"features.{idx}.weight"] = t(np.asarray(p["weight"]).transpose(3, 2, 0, 1))
        sd[f"features.{idx}.bias"] = t(np.asarray(p["bias"]))
    for i, w in enumerate(params["lins"]):
        sd[f"lins.{i}"] = t(np.asarray(w))
    model = TLP.LPIPS()
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_lpips_matches_jax():
    params = JLP.init_lpips(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    a, b = rng.uniform(-1, 1, (2, 2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JLP.lpips(params, jnp.asarray(a), jnp.asarray(b)))
    model = _port_lpips(params)
    with torch.no_grad():
        ours = TLP.lpips(model, t(a), t(b))
        same = TLP.lpips(model, t(a), t(a))
    assert ours.shape == (2,)
    assert_close(ours, ref, TOL, 0.0, "lpips")
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


def _lpips_package_sd(rng):
    convs = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]
    sd = {}
    for i, ((ci, co, k), ix) in enumerate(zip(convs, (0, 3, 6, 8, 10))):
        sd[f"net.slice{i + 1}.{ix}.weight"] = t(rng.normal(size=(co, ci, k, k)).astype(np.float32)
                                                * 0.05)
        sd[f"net.slice{i + 1}.{ix}.bias"] = t(rng.normal(size=(co,)).astype(np.float32) * 0.01)
        sd[f"lin{i}.model.1.weight"] = t(np.abs(rng.normal(size=(1, co, 1, 1))).astype(np.float32))
    return sd


@pytest.mark.parametrize("layout", ["lpips", "torchvision", "wrapped"])
def test_load_lpips_matches_jax(tmp_path, monkeypatch, layout):
    rng = np.random.default_rng(4)
    sd = _lpips_package_sd(rng)
    if layout == "torchvision":   # features.N.*, no heads: uniform weights 1/C
        sd = {"features." + k.split(".", 2)[2]: v for k, v in sd.items() if k.startswith("net.")}
    elif layout == "wrapped":
        sd = {"state_dict": sd}
    path = str(tmp_path / "lpips.pth")
    torch.save(sd, path)
    monkeypatch.delenv("MUDG_LPIPS_PATH", raising=False)
    assert TLP.load_lpips(None, device="cpu") is None
    assert TLP.load_lpips(str(tmp_path / "missing.pth"), device="cpu") is None
    monkeypatch.setenv("MUDG_LPIPS_PATH", path)
    model = TLP.load_lpips(None, device="cpu")
    params = JLP.load_lpips(path)
    ref_model = _port_lpips(params)
    for k, v in ref_model.state_dict().items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    if layout == "torchvision":
        assert float(model.lins[0][0].detach()) == pytest.approx(1 / 64)
    a, b = rng.uniform(-1, 1, (2, 1, 48, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ours = TLP.lpips(model, t(a), t(b))
    assert_close(ours, np.asarray(JLP.lpips(params, a, b)), TOL, 0.0, "lpips")


def _eval_dirs(root, rng, hw=(48, 64), n=3):
    import cv2

    color, sem, dep, gtd = (root / "virtual_color", root / "virtual_semantic",
                            root / "virtual_depth", root / "six_frames_depth")
    for d in (color, sem, dep, gtd):
        d.mkdir()
    for i in range(n):
        gt = (rng.random((*hw, 3)) * 255).astype(np.uint8)
        noisy = np.clip(gt.astype(int) + rng.integers(-30, 30, gt.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(str(color / f"color_gt_{i}.png"), gt)
        cv2.imwrite(str(color / f"color_re_{i}.png"), noisy)
        ids_gt = rng.integers(0, 19, hw)
        ids_re = np.where(rng.uniform(size=hw) < 0.3, rng.integers(0, 19, hw), ids_gt)
        for name, ids in (("gt", ids_gt), ("re", ids_re)):
            cv2.imwrite(str(sem / f"semantic_{name}_{i}.png"),
                        JM.encode_semantic(ids)[:, :, ::-1].astype(np.uint8))
        d_gt = np.where(rng.uniform(size=hw) < 0.8, rng.uniform(1, 80, hw), 0).astype(np.float32)
        np.save(gtd / f"{i:08d}.npy", d_gt)
        np.save(dep / f"depth_re_{i}.npy", (d_gt * rng.uniform(0.7, 1.4, hw)).astype(np.float32))
    return color, sem, dep, gtd


def test_eval_app_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    color, sem, dep, gtd = _eval_dirs(tmp_path, rng)
    lp = str(tmp_path / "lpips.pth")
    torch.save(_lpips_package_sd(rng), lp)
    cases = {"color": ["--dir", str(color), "--lpips", lp],
             "semantic": ["--dir", str(sem), "--task", "semantic"],
             "depth": ["--dir", str(dep), "--task", "depth", "--gt_depth", str(gtd)]}
    summaries = {}
    for task, argv in cases.items():
        rows = {}
        for name, app, extra in (("ours", TAPP, ["--device", "cpu"]), ("theirs", JAPP, [])):
            out = str(tmp_path / f"{task}_{name}.jsonl")
            summary = app.main(argv + ["--out", out] + extra)
            rows[name] = (summary, [json.loads(line) for line in open(out)])
        (ours, o_rows), (theirs, t_rows) = rows["ours"], rows["theirs"]
        assert ours.keys() == theirs.keys() and ours["n_frames"] == 3, task
        assert len(o_rows) == len(t_rows) == 3
        for o, r in zip(o_rows + [ours], t_rows + [theirs]):
            assert o.keys() == r.keys()
            for k, v in r.items():
                if k.split("_")[0] in ("ssim", "lpips"):   # fp32 sums: one rounding step
                    assert abs(o[k] - v) <= 1e-4 + 1e-12, (task, k)
                else:
                    assert o[k] == v, (task, k)
        summaries[task] = ours
    assert summaries["color"]["lpips_mean"] > 0
    assert summaries["semantic"]["miou_mean"] < 1 and summaries["depth"]["delta1_mean"] < 1


@pytest.mark.parametrize("num_classes", [19, 21])
def test_decode_semantic_matches_jax(num_classes):
    """The port's class-at-a-time palette decode gives JAX's ids and colors
    bit for bit: on float frames, on exact palette colors, and on the
    midpoints between two palette colors, where the distances tie and the
    lower class wins."""
    rng = np.random.default_rng(6)
    pal = JM.SEMANTIC_PALETTE[:num_classes].astype(np.float32)
    i, j = rng.integers(0, num_classes, (2, 64, 96))
    frames = [rng.uniform(-20, 275, (64, 96, 3)).astype(np.float32),
              pal[i] + rng.normal(0, 3, (64, 96, 3)).astype(np.float32),
              pal[i], (pal[i] + pal[j]) / 2,
              rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)]
    for x in frames:
        ours, ref = TM.decode_semantic(x, num_classes), JM.decode_semantic(x, num_classes)
        for o, r in zip(ours, ref):
            assert o.dtype == r.dtype
            np.testing.assert_array_equal(o, r)


def test_profiling_helpers(tmp_path):
    """Without CUDA device_memory_stats is empty; trace writes a Chrome
    trace that carries the program's spans, on inside it and off after."""
    from mudg_tpu_torch.utils import profiling as TP

    if not torch.cuda.is_available():
        assert TP.device_memory_stats() == []
    with TP.trace(str(tmp_path / "trace")) as prof:
        with TP.span("unet"):
            torch.ones(4).sum()
    assert prof is not None
    assert '"mudg.unet"' in (tmp_path / "trace" / "trace.json").read_text()
    assert TP.span("unet") is TP.span("vae.decode")    # off again: the shared null context
    TP.reset_spans()
