"""The port's point-cloud stage against the JAX package's, on the CPU: the
voxel cells as JAX's native (C++) library picks them, the lidar ops of
`render/lidar.py`, `build_scene_clouds` on an ETL scene, the COLMAP reader
and the SfM + LiDAR merge, and the chain tfrecord -> preprocess ->
build_clouds -> conditions on the port alone.

Clouds are compared as sorted rows within 1e-6 relative. Points whose
projection lies at a pixel rounding tie or whose box coordinate lies at a
box face may fall apart (the C++ may fuse multiply-adds); they are counted
and each may move one row of a per-frame cloud or two voxel centroids.
Every scene is written under the test's own tmp_path.
"""
from __future__ import annotations

import os
import pickle
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as CS
from mudg_tpu.apps import build_clouds as JBC
from mudg_tpu.data import waymo_etl as JE
from mudg_tpu.render import lidar as JL
from mudg_tpu.render import pointcloud as JPC
from mudg_tpu_torch.apps import build_clouds as TBC
from mudg_tpu_torch.apps import refine_gs as TRG
from mudg_tpu_torch.data import waymo_etl as TE
from mudg_tpu_torch.render import lidar as TL
from mudg_tpu_torch.render import pointcloud as TPC
from mudg_tpu_torch.utils import native as TN
from test_torch_util import jax_native, tree_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMS = tuple((c[0], c[1], 192, 128 if c[3] == 1280 else 89, c[4]) for c in CS.WAYMO_CAMS)
CLOUD_REL = 1e-6


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    return jax_native(tmp_path_factory.mktemp("native"))


def _rows(xyz, rgb):
    a = np.concatenate([np.asarray(xyz, np.float64), np.asarray(rgb, np.float64)], 1)
    return a[np.lexsort(a.T[::-1])]


# ---------------------------------------------------------------------------
# the voxel cells (the repair: the port once took floor(float32(x / voxel)))
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("voxel", [0.1, 0.05])
def test_voxel_cells_at_boundaries_match_native(jnative, voxel):
    """x = float32(k * voxel) for k in [-1000, 1000], each beside a point at
    the centre of the cell below and of the cell above it: which of the two
    it joins shows its cell. The rows equal the C++'s, sorted; floor(x /
    voxel) in float32 puts hundreds of these points in the other cell."""
    k = np.arange(-1000, 1001)
    edge = (k * voxel).astype(np.float32)
    below, above = ((k - 0.5) * voxel).astype(np.float32), ((k + 0.5) * voxel).astype(np.float32)
    x = np.concatenate([edge, below, above])
    xyz = np.stack([x, np.full_like(x, 0.3 * voxel), np.full_like(x, 0.6 * voxel)], 1)
    rgb = np.random.default_rng(0).random(xyz.shape).astype(np.float32)
    ours = TN.voxel_downsample(xyz, rgb, voxel)
    ref = jnative.voxel_downsample(xyz, rgb, voxel)
    np.testing.assert_array_equal(_rows(*ours), _rows(*ref))
    assert ours[0].dtype == np.float32 and ours[1].dtype == np.float32
    cells = TN.voxel_cells(torch.from_numpy(edge[:, None]), voxel)[:, 0].numpy()
    float32_cells = np.floor(edge / np.float32(voxel)).astype(np.int64)
    assert (cells != float32_cells).sum() > 100   # where the float32 quotient misplaces them


@pytest.mark.parametrize("voxel", [0.1, 0.05])
def test_voxel_downsample_matches_native(jnative, voxel):
    """200k seeded points in +-60 m with colours: the same rows as the C++
    (sorted by cell here), on numpy and on tensors, uint8 colours through
    float32 as the JAX wrapper casts them; no points: the inputs back."""
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-60, 60, (200_000, 3)).astype(np.float32)
    xyz[:, 2] *= 0.05
    rgb = rng.random((200_000, 3)).astype(np.float32)
    ours = TN.voxel_downsample(xyz, rgb, voxel)
    ref = jnative.voxel_downsample(xyz, rgb, voxel)
    np.testing.assert_array_equal(_rows(*ours), _rows(*ref))
    cells = TN.voxel_cells(torch.from_numpy(ours[0]), voxel).numpy()
    assert (np.diff(cells[:, 0]) >= 0).all()   # rows sorted by cell
    t_xyz, t_rgb = TN.voxel_downsample(torch.from_numpy(xyz), torch.from_numpy(rgb), voxel)
    assert np.array_equal(t_xyz.numpy(), ours[0]) and np.array_equal(t_rgb.numpy(), ours[1])
    u8 = (rgb * 255).astype(np.uint8)
    np.testing.assert_array_equal(_rows(*TN.voxel_downsample(xyz, u8, voxel)),
                                  _rows(*jnative.voxel_downsample(xyz, u8, voxel)))
    empty = np.zeros((0, 3), np.float32)
    assert TN.voxel_downsample(empty, empty, voxel)[0] is empty


def test_refine_gs_initial_cloud_matches_jax(jnative, tmp_path):
    """refine-gs's initial cloud (background.ply voxel downsampled at
    --voxel 0.15 where it holds more than capacity // 2 points, then cut to
    capacity): the port's `initial_cloud` equals JAX's (refine_gs.py:161-165)
    as sorted rows."""
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-40, 40, (150_000, 3)).astype(np.float32)
    xyz[:, 1] = rng.normal(0, 0.3, 150_000)
    (tmp_path / "objects").mkdir()
    JPC.store_ply(str(tmp_path / "objects" / "background.ply"), xyz,
                  rng.integers(0, 256, (150_000, 3)).astype(np.uint8))
    cap, voxel = 200_000, 0.15
    jx, jc, _ = JPC.fetch_ply(str(tmp_path / "objects" / "background.ply"))
    jx, jc = jnative.voxel_downsample(jx, jc, voxel)
    n0 = min(len(jx), cap)
    ox, oc = TRG.initial_cloud(str(tmp_path), cap, voxel, "cpu")
    assert len(ox) == n0 < len(xyz)
    np.testing.assert_array_equal(_rows(ox, oc), _rows(jx[:n0], jc[:n0]))


# ---------------------------------------------------------------------------
# render/lidar and build_scene_clouds on an ETL scene
# ---------------------------------------------------------------------------

@pytest.fixture
def etl_scene(tmp_path):
    rec = str(tmp_path / "seg.tfrecord")
    CS.waymo_segment(rec, 3, cams=CAMS, top=(32, 400), short=(8, 30), boxes=(12, 4))
    scene = str(tmp_path / "scene")
    TE.process_sequence(rec, scene, device="cpu")
    return scene


def _frame(scene, index):
    with open(os.path.join(scene, "scenario.pt"), "rb") as f:
        sc = pickle.load(f)
    with np.load(os.path.join(scene, "lidars", "lidar_TOP", f"{index:08d}.npz")) as z:
        data = {k: z[k] for k in z.files}
    return sc, data


def _tie_points(xyz, cams):
    """Points whose projection into a camera lies within 1e-9 (relative) of
    an integer pixel coordinate, the frame's edges included."""
    near = np.zeros(len(xyz), bool)
    for cam in cams:
        w2c = np.linalg.inv(cam["c2w"])
        p = xyz.astype(np.float64) @ w2c[:3, :3].T + w2c[:3, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            for uv in (cam["K"][0, 0] * p[:, 0] / p[:, 2] + cam["K"][0, 2],
                       cam["K"][1, 1] * p[:, 1] / p[:, 2] + cam["K"][1, 2]):
                near |= np.abs(uv - np.round(uv)) <= 1e-9 * np.maximum(np.abs(uv), 1)
    return near


def test_lidar_ops_match_jax(etl_scene, jnative):
    """One frame: the lidar rays into the world, the hit points, the colours
    from the five cameras (equal but at pixel ties, which are counted), the
    box segmentation (equal but at box faces) and the voxel clouds, against
    JAX's render/lidar on the same inputs."""
    sc, data = _frame(etl_scene, 1)
    lidar = sc["observers"]["lidar_TOP"]
    l2w = lidar["data"]["l2w"][1]
    jo, jd = JE.lidar_frame_to_world(data["rays_o"].reshape(-1, 3), data["rays_d"].reshape(-1, 3),
                                     l2w)
    to, td = TE.lidar_frame_to_world(torch.from_numpy(data["rays_o"].reshape(-1, 3)),
                                     torch.from_numpy(data["rays_d"].reshape(-1, 3)), l2w)
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-15, atol=1e-12)
    ranges = data["ranges"].reshape(-1)
    jxyz, jvalid = JL.rays_to_points(jo, jd, ranges)
    txyz, tvalid = TL.rays_to_points(to, td, torch.from_numpy(ranges))
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    assert np.abs(txyz.numpy() - jxyz).max() <= 1e-6 * np.abs(jxyz).max()
    cams = JBC._frame_cameras(etl_scene, sc["observers"], TBC.DEFAULT_CAMERAS, 1)
    assert [c["image"].shape for c in cams] == [c["image"].shape for c in TBC._frame_cameras(
        etl_scene, sc["observers"], TBC.DEFAULT_CAMERAS, 1)]
    jrgb, jcol = JL.color_points_from_cameras(jxyz, cams)
    trgb, tcol = TL.color_points_from_cameras(torch.from_numpy(jxyz), cams)
    differ = (tcol.numpy() != jcol) | (trgb.numpy() != jrgb).any(1)
    ties = _tie_points(jxyz, cams)
    assert jcol.sum() > 100 and (differ & ~ties).sum() == 0
    print(f"colours: {int(differ.sum())} points differ, {int(ties.sum())} at pixel ties")
    moving = [o for o in JBC.flatten_objects(sc) if JL.is_object_moving(
        o["transform_obj"][o["visibility"] > 0][:, :3, 3])]
    assert [o["id"] for o in moving] == [o["id"] for o in TBC.flatten_objects(sc)
                                         if TL.is_object_moving(
                                             o["transform_obj"][o["visibility"] > 0][:, :3, 3])]
    frame_objs = [dict(id=o["id"], transform_obj=o["transform_obj"][1], size=o["bbox"][1])
                  for o in moving]
    jsegs, jbg = JL.segment_objects(jxyz, jrgb, frame_objs)
    tsegs, tbg = TL.segment_objects(torch.from_numpy(jxyz), torch.from_numpy(jrgb), frame_objs)
    assert sum(s["count"] for s in jsegs) > 0
    faces = 0
    for js, ts in zip(jsegs, tsegs):
        assert js["id"] == ts["id"]
        faces += abs(js["count"] - ts["count"])
        if js["count"] == ts["count"]:
            np.testing.assert_allclose(ts["points"].numpy(), js["points"], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(ts["colors"].numpy(), js["colors"])
    assert faces == int((tbg.numpy() != jbg).sum()) <= 2
    o_ours = TL.aggregate_object_cloud([s["points"] for s in tsegs if s["count"]],
                                       [s["colors"] for s in tsegs if s["count"]])
    o_ref = JL.aggregate_object_cloud([s["points"] for s in jsegs if s["count"]],
                                      [s["colors"] for s in jsegs if s["count"]])
    if not faces:
        np.testing.assert_allclose(_rows(o_ours[0].numpy(), o_ours[1].numpy()), _rows(*o_ref),
                                   rtol=0, atol=1e-5)
    b_ours = TL.build_background_cloud([torch.from_numpy(jxyz)], [torch.from_numpy(jrgb)])
    b_ref = JL.build_background_cloud([jxyz], [jrgb])
    assert len(b_ref[0]) > 100
    np.testing.assert_array_equal(_rows(b_ours[0].numpy(), b_ours[1].numpy()), _rows(*b_ref))
    empty = TL.aggregate_object_cloud([], [])
    assert empty[0].shape == (0, 3) and empty[0].dtype == torch.float32
    assert TL.is_object_moving(np.zeros((1, 3))) is False


def _clouds(scene, reader):
    out = {}
    with open(os.path.join(scene, "objects_info.pkl"), "rb") as f:
        info = pickle.load(f)
    for o in info:
        out["object " + o["id"]] = _rows(o["point_cloud"]["points"], o["point_cloud"]["colors"])
    for d in ("objects", "lidar_clouds"):
        for name in sorted(os.listdir(os.path.join(scene, d))):
            xyz, rgb, _ = reader(os.path.join(scene, d, name))
            out[f"{d}/{name}"] = _rows(xyz, rgb)
    return info, out


def test_build_scene_clouds_matches_jax(etl_scene, jnative, tmp_path):
    """build_scene_clouds on the CPU against JAX's on the same ETL scene
    (five cameras): the moving objects' records equal, every cloud's rows
    within 1e-6 relative but for the rows that tie and face points may move
    (counted; none expected on this scene); the split of its seconds."""
    import shutil

    jscene = str(tmp_path / "jax_scene")
    shutil.copytree(etl_scene, jscene)
    jinfo = JBC.build_scene_clouds(jscene)
    timings = {}
    tinfo = TBC.build_scene_clouds(etl_scene, device="cpu", timings=timings)
    assert set(timings) == set(TBC.STAGES)
    keys = ("id", "class_name", "visibility", "bbox", "transform_obj")
    tree_equal([{k: o[k] for k in keys} for o in tinfo], [{k: o[k] for k in keys} for o in jinfo])
    assert len(jinfo) == 4
    _, ours = _clouds(etl_scene, TPC.fetch_ply)
    _, ref = _clouds(jscene, JPC.fetch_ply)
    assert sorted(ours) == sorted(ref)
    n_diff = 0
    for k, r in ref.items():
        o = ours[k]
        if o.shape != r.shape:
            n_diff += abs(len(o) - len(r)) + 1
            continue
        n_diff += int((np.abs(o - r) > CLOUD_REL * np.abs(r).max()).any(1).sum())
    print(f"build_clouds: {n_diff} rows differ over {sum(len(r) for r in ref.values())}")
    assert n_diff == 0
    assert len(ref["objects/background.ply"]) > 1000


def test_build_clouds_cli(etl_scene):
    """`python -m mudg_tpu_torch.apps.build_clouds --device cpu` writes the
    files `conditions` and `refine-gs` read."""
    r = subprocess.run([sys.executable, "-m", "mudg_tpu_torch.apps.build_clouds", "--scene",
                        etl_scene, "--device", "cpu", "--limit_frames", "2"],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "moving objects" in r.stdout
    for f in ("objects/background.ply", "objects_info.pkl", "lidar_clouds/00000001.ply"):
        assert os.path.exists(os.path.join(etl_scene, f)), f
    assert not os.path.exists(os.path.join(etl_scene, "lidar_clouds", "00000002.ply"))


# ---------------------------------------------------------------------------
# COLMAP points and the SfM + LiDAR merge
# ---------------------------------------------------------------------------

def test_colmap_reader_and_merge_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    n = 23
    path = str(tmp_path / "points3D.bin")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<Qddd", i + 1, *rng.normal(0, 10, 3)))
            f.write(struct.pack("<BBB", *rng.integers(0, 256, 3)))
            f.write(struct.pack("<d", rng.random()))
            tl = int(rng.integers(0, 5))
            f.write(struct.pack("<Q", tl) + b"".join(struct.pack("<ii", t, 2 * t)
                                                     for t in range(tl)))
    tree_equal(TPC.read_colmap_points3d_bin(path), JPC.read_colmap_points3d_bin(path))
    ply = str(tmp_path / "lidar.ply")
    JPC.store_ply(ply, rng.normal(0, 5, (9, 3)).astype(np.float32),
                  rng.integers(0, 256, (9, 3)).astype(np.uint8))
    ours = TPC.merge_sfm_lidar(str(tmp_path / "t.ply"), path, ply)
    ref = JPC.merge_sfm_lidar(str(tmp_path / "j.ply"), path, ply)
    tree_equal(ours, ref)
    assert open(tmp_path / "t.ply", "rb").read() == open(tmp_path / "j.ply", "rb").read()


# ---------------------------------------------------------------------------
# the chain on the port alone
# ---------------------------------------------------------------------------

def test_tfrecord_to_conditions_on_the_port(tmp_path):
    """A five-camera tfrecord -> `python -m mudg_tpu_torch preprocess` ->
    build_clouds -> `conditions`, each through its command on the CPU,
    each reading only the files the one before wrote."""
    raw = tmp_path / "raw"
    raw.mkdir()
    CS.waymo_segment(str(raw / "seg.tfrecord"), 3, cams=CAMS, top=(32, 400), short=(8, 30),
                     boxes=(12, 4))
    env = dict(os.environ, PYTHONPATH=REPO)
    for cmd in (["-m", "mudg_tpu_torch", "preprocess", "--root", str(raw), "--out_root",
                 str(tmp_path / "out"), "-j", "1"],
                ["-m", "mudg_tpu_torch.apps.build_clouds", "--scene",
                 str(tmp_path / "out" / "seg")],
                ["-m", "mudg_tpu_torch", "conditions", "--scene", str(tmp_path / "out" / "seg"),
                 "--render_virtual"]):
        r = subprocess.run([sys.executable, *cmd, "--device", "cpu"], capture_output=True,
                           text=True, timeout=300, cwd=REPO, env=env)
        assert r.returncode == 0, (cmd, r.stderr)
    scene = tmp_path / "out" / "seg"
    depth = [np.load(scene / "depth" / "camera_FRONT" / f"{i:08d}.npy") for i in range(3)]
    assert all(d.shape == (128, 192) and (d > 0).mean() > 0.01 for d in depth)
    assert len(os.listdir(scene / "virtual_depth" / "camera_FRONT")) == 3 * 2
