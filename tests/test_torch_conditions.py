"""The port's `conditions` app and its splatting (`render/splat.py`,
`render/pointcloud.py`, `apps/make_conditions.py`) against the JAX package
on the CPU, on seeded synthetic clouds and on copies of the shared `scene`
fixture (the JAX apps' tests write sparse/ and depth/ into the scene
itself).

Tolerance: depth and color equal at >= 99.9% of pixels, and every pixel
that differs has a JAX-projected u or v within 1e-4 of a half-integer (a
rounding tie, which the last bit of a projection can move); masks, the .npy
depth maps, the images the JPEGs are encoded from and the virtual item list
equal.
"""
from __future__ import annotations

import os
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from mudg_tpu.apps import make_conditions as JMC
from mudg_tpu.render import pointcloud as JPC
from mudg_tpu.render import splat as JS
from mudg_tpu_torch.apps import make_conditions as TMC
from mudg_tpu_torch.render import pointcloud as TPC
from mudg_tpu_torch.render import splat as TS
from test_torch_util import t

MATCH = 0.999
TIE = 1e-4
H, W = 120, 160
K = np.array([[140.0, 0, 80.5], [0, 140.0, 60.5], [0, 0, 1]], np.float32)


def _pose(angle, trans):
    c, s = np.cos(angle), np.sin(angle)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    c2w[:3, 3] = trans
    return c2w


def _cloud(rng, n, center, spread):
    xyz = (rng.normal(0, spread, (n, 3)) + center).astype(np.float32)
    return xyz, rng.random((n, 3)).astype(np.float32)


def _ties(xyz, c2w, size):
    """Pixels that a rounding tie of a point's JAX-projected u or v could
    move: every pixel of the footprint of such a point, widened by one."""
    u, v, z = (np.asarray(a) for a in JS.project_points(
        jnp.asarray(xyz), jnp.asarray(K), jnp.asarray(np.linalg.inv(c2w))))
    tie = (np.abs(u - np.floor(u) - 0.5) < TIE) | (np.abs(v - np.floor(v) - 0.5) < TIE)
    near = np.zeros((H, W), bool)
    r = max(int(round(size)), 1) // 2 + 1
    for uu, vv in zip(np.round(u[tie]).astype(int), np.round(v[tie]).astype(int)):
        near[max(vv - r, 0):vv + r + 1, max(uu - r, 0):uu + r + 1] = True
    return near


def _assert_maps(ours, ref, near, name):
    """ours and ref (H, W[, 3]) equal at >= MATCH of the pixels, and every
    differing pixel among `near`."""
    diff = ours != ref
    if diff.ndim == 3:
        diff = diff.any(-1)
    assert diff.mean() <= 1 - MATCH, (name, diff.mean())
    assert not (diff & ~near).any(), (name, np.argwhere(diff & ~near)[:5])


@pytest.mark.parametrize("size", [1.0, 2.5, 4.0])
def test_splat_points_matches_jax(size):
    rng = np.random.default_rng(70 + int(size))
    xyz, rgb = _cloud(rng, 40000, [0.0, 0.0, 12.0], 4.0)
    c2w = _pose(0.3, [0.7, -0.2, 1.3])
    w2c = np.linalg.inv(c2w)
    jc, jd = JS.splat_points(jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(K),
                             jnp.asarray(w2c), height=H, width=W, point_size=size)
    tc, td = TS.splat_points(t(xyz), t(rgb), t(K), t(w2c), height=H, width=W, point_size=size)
    near = _ties(xyz, c2w, size)
    _assert_maps(tc.numpy(), np.asarray(jc), near, "color")
    _assert_maps(td.numpy(), np.asarray(jd), near, "depth")
    assert (td.numpy() > 0).mean() > 0.3   # the cloud covers the image


def test_dilate_mask_matches_jax():
    m = np.random.default_rng(71).random((H, W)) > 0.995
    np.testing.assert_array_equal(TS.dilate_mask(t(m)).numpy(),
                                  np.asarray(JS.dilate_mask(jnp.asarray(m))))


def test_render_sparse_frame_matches_jax():
    rng = np.random.default_rng(72)
    bg_xyz, bg_rgb = _cloud(rng, 60000, [0.0, 0.0, 14.0], 5.0)
    obj_xyz, obj_rgb = _cloud(rng, 2000, [1.0, 0.0, 8.0], 0.8)
    c2w = _pose(-0.2, [0.3, 0.1, -0.5])
    ref = JS.render_sparse_frame(jnp.asarray(bg_xyz), jnp.asarray(bg_rgb), jnp.asarray(obj_xyz),
                                 jnp.asarray(obj_rgb), jnp.asarray(K), jnp.asarray(c2w),
                                 height=H, width=W)
    ours = TS.render_sparse_frame(t(bg_xyz), t(bg_rgb), t(obj_xyz), t(obj_rgb), t(K), c2w,
                                  height=H, width=W)
    near = _ties(bg_xyz, c2w, 2.5) | _ties(obj_xyz, c2w, 4.0)
    jc, jd, jm = (np.asarray(a) for a in ref)
    tc, td, tm = (a.numpy() for a in ours)
    np.testing.assert_array_equal(tm, jm)
    assert 0.01 < tm.mean() < 0.9   # the objects cover part of the frame
    _assert_maps(tc, jc, near, "color")
    _assert_maps(td, jd, near, "depth")


def test_hidden_point_removal_and_objects_match_jax():
    rng = np.random.default_rng(73)
    xyz = rng.normal(0, 3, (3000, 3)) + [0, 0, 10]
    cam = np.array([0.2, -0.1, 0.0])
    np.testing.assert_array_equal(TPC.hidden_point_removal(xyz, cam),
                                  JPC.hidden_point_removal(xyz, cam))
    info = [{"visibility": np.array([1, 0, 1]),
             "transform_obj": [_pose(0.1 * i, [i, 0, 5]).astype(np.float64) for i in range(3)],
             "point_cloud": {"points": rng.normal(0, 1, (20 + k, 3)).astype(np.float32),
                             "colors": rng.random((20 + k, 3)).astype(np.float32)}}
            for k in range(3)]
    info[1]["visibility"] = np.array([0, 0, 1])
    vis = TPC.object_visibility_table(info)
    np.testing.assert_array_equal(vis, JPC.object_visibility_table(info))
    for frame in range(3):
        for ours, ref in zip(TPC.merge_objects_at_frame(info, vis, frame),
                             JPC.merge_objects_at_frame(info, vis, frame)):
            np.testing.assert_array_equal(ours, ref)


def _scene_copy(scene, dst):
    """A copy of the shared scene fixture with per-frame lidar clouds for
    --six_frame_depth (seeded; the fixture has none)."""
    shutil.copytree(scene, dst)
    rng = np.random.default_rng(74)
    os.makedirs(dst / "lidar_clouds")
    for i in range(4):
        xyz, rgb = _cloud(rng, 3000, [0.0, 0.0, 8.0 + i], 2.0)
        TPC.store_ply(str(dst / "lidar_clouds" / f"{i:08d}.ply"), xyz,
                      (rgb * 255).astype(np.uint8))
    return dst


def _saved_images(monkeypatch, media):
    """Record every image a saver is given, by path, and write it."""
    seen = {}
    save = media.save_image

    def record(path, img):
        seen[os.path.basename(os.path.dirname(os.path.dirname(path))) + "/"
             + os.path.basename(path)] = np.array(img)
        save(path, img)

    monkeypatch.setattr(media, "save_image", record)
    return seen


def test_conditions_app_matches_jax(scene, tmp_path, monkeypatch):
    from mudg_tpu.utils import media as jmedia
    from mudg_tpu_torch.utils import media as tmedia

    jdir, tdir = _scene_copy(scene, tmp_path / "jax"), _scene_copy(scene, tmp_path / "port")
    args = ["--render_virtual", "--six_frame_depth", "--window", "2"]
    jimg, timg = _saved_images(monkeypatch, jmedia), _saved_images(monkeypatch, tmedia)
    JMC.main(["--scene", str(jdir), *args, "--emit_virtual_items", str(jdir / "items.txt")])
    assert TMC.main(["--scene", str(tdir), *args, "--emit_virtual_items",
                     str(tdir / "items.txt"), "--device", "cpu"]) == 0
    outs = ("sparse", "depth", "virtual_sparse", "virtual_depth", "six_frames_depth",
            "six_frames_sparse")

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for o in outs for d, _, fs in os.walk(root / o) for f in fs)

    assert files(tdir) == files(jdir) and len(files(jdir)) == 4 * 3 + 8 * 3 + 4 * 2
    for name in files(jdir):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tdir / name), np.load(jdir / name))
    assert sorted(timg) == sorted(jimg)
    for name in jimg:
        np.testing.assert_array_equal(timg[name], jimg[name], err_msg=name)
    with open(jdir / "objects_info.pkl", "rb") as f:
        assert pickle.load(f)   # the scene holds objects, so the masks were made
    jitems = (jdir / "items.txt").read_text().replace(str(jdir), "<scene>")
    titems = (tdir / "items.txt").read_text().replace(str(tdir), "<scene>")
    assert titems == jitems and titems.strip()


def test_cli_runs_the_new_commands(capsys):
    """`conditions`, its alias `make-conditions`, `quantize`, `eval`, its
    alias `eval-nvs`, `segment` and `densify` no longer exit 2 as "not
    ported"; `preprocess` still does."""
    from mudg_tpu_torch.__main__ import main

    for cmd in ("conditions", "make-conditions", "quantize", "eval", "eval-nvs", "segment",
                "densify"):
        with pytest.raises(SystemExit) as e:
            main([cmd, "--help"])
        assert e.value.code == 0, cmd
        assert "--device" in capsys.readouterr().out, cmd
    assert main(["preprocess", "--help"]) == 2


def test_conditions_entry_points_default_to_cuda():
    import inspect

    for fn in (TMC.render_scene_conditions, TMC.render_six_frame_depth):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
