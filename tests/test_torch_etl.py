"""The port's host ETL against the JAX package's, on the CPU: the Waymo wire
decoder, the record framing and point ops against JAX's native (C++)
library, `process_sequence` field by field, the `preprocess` command at -j
1 and -j 2, `SceneReader` and `VideoClipDataset`.

The records are tests/test_waymo_proto.py's `build_frame` (one camera, two
lidars, two labels, unknown fields) and chip_smoke.py's `waymo_segment` at a
small size (five cameras, the TOP lidar with its pose image, four short
lidars, moving and static boxes of every class). Every scene is written
under the test's own tmp_path. The ETL's float64 ray and pose math is held
to 1e-12 relative (scenario.pt) and its npz arrays bit for bit: the CPU
runs the same IEEE operations as numpy.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as CS
from mudg_tpu.data import scene as JS
from mudg_tpu.data import video as JV
from mudg_tpu.data import waymo_etl as JE
from mudg_tpu.data import waymo_proto as JP
from mudg_tpu_torch.data import scene as TS
from mudg_tpu_torch.data import video as TV
from mudg_tpu_torch.data import waymo_etl as TE
from mudg_tpu_torch.data import waymo_proto as TP
from mudg_tpu_torch.utils import native as TN
from test_torch_util import jax_native, tree_equal
from test_waymo_proto import build_frame, write_tfrecord

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CAMS = tuple((c[0], c[1], 96, 64 if c[3] == 1280 else 44, c[4]) for c in CS.WAYMO_CAMS)
SMALL = dict(cams=SMALL_CAMS, top=(16, 200), short=(8, 30), boxes=(8, 3))


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    return jax_native(tmp_path_factory.mktemp("native"))


def _segment(path, frames=3, seed=CS.SEED + 19):
    CS.waymo_segment(str(path), frames, seed, **SMALL)
    return str(path)


@pytest.mark.parametrize("source", ["build_frame", "waymo_segment"])
def test_parse_frame_matches_jax(tmp_path, source):
    """Every decoded field, bit for bit, on records with unknown fields and
    on the five-camera segment's records."""
    if source == "build_frame":
        records = [build_frame(i) for i in range(2)]
    else:
        data = open(_segment(tmp_path / "s.tfrecord", 2), "rb").read()
        records = [data[o:o + n] for o, n in TN.tfrecord_index(data)]
        assert len(records) == 2
    for rec in records:
        tree_equal(TP.parse_frame(rec), JP.parse_frame(rec))
    tree_equal(TP.decode_compressed_matrix(
        JP.parse_frame(records[0]).lasers[0].ri_return1.range_image_compressed),
        JP.decode_compressed_matrix(
            JP.parse_frame(records[0]).lasers[0].ri_return1.range_image_compressed))


def test_tfrecord_index_matches_native(jnative):
    payloads = [b"", b"a", b"hello" * 30, bytes(range(256))]
    data = b"".join(len(p).to_bytes(8, "little") + b"\0" * 4 + p + b"\0" * 4 for p in payloads)
    for cut in (len(data), len(data) - 3, 11, 0):   # a truncated tail record ends the scan
        assert TN.tfrecord_index(data[:cut]) == jnative.tfrecord_index(data[:cut])
    assert len(TN.tfrecord_index(data)) == 4


def _box_points(rng, n, w2b, half):
    """Random points, a third of them on or within 1e-7 of a box face."""
    b2w = np.linalg.inv(w2b.astype(np.float64))
    box = rng.uniform(-1.5, 1.5, (n, 3)) * half
    face = rng.integers(0, 3, n // 3)
    box[np.arange(n // 3), face] = np.sign(rng.standard_normal(n // 3)) * half[face] * (
        1 + rng.uniform(-1e-7, 1e-7, n // 3))
    return (box @ b2w[:3, :3].T + b2w[:3, 3]).astype(np.float32)


def test_point_ops_match_native(jnative):
    """transform_points within 4 fp32 epsilons of its terms' magnitude of
    the C++ (which may fuse multiply-adds) and points_in_box equal except
    at the faces, on numpy inputs (numpy out) and tensors (tensors out);
    the points within 1e-6 of a face are counted."""
    rng = np.random.default_rng(0)
    w2b = np.linalg.inv(CS._pose4(3.0, -2.0, 0.8, 0.7, 0.01, -0.02)).astype(np.float32)
    half = np.array([2.25, 1.0, 0.8])
    xyz = _box_points(rng, 30_000, w2b, half)
    ours = TN.transform_points(xyz, w2b)
    ref = jnative.transform_points(xyz, w2b)
    assert isinstance(ours, np.ndarray) and ours.dtype == np.float32
    terms = np.abs(xyz) @ np.abs(w2b[:3, :3]).T + np.abs(w2b[:3, 3])   # the sums' magnitudes
    assert (np.abs(ours - ref) <= 4 * np.finfo(np.float32).eps * terms).all()
    assert torch.equal(TN.transform_points(torch.from_numpy(xyz), w2b), torch.from_numpy(ours))
    m_ours, m_ref = TN.points_in_box(xyz, w2b, half), jnative.points_in_box(xyz, w2b, half)
    b = xyz.astype(np.float64) @ w2b[:3, :3].T.astype(np.float64) + w2b[:3, 3]
    at_face = (np.abs(np.abs(b) - half) <= 1e-6 * half).any(1)
    assert at_face.sum() > 1000
    assert (m_ours == m_ref)[~at_face].all()
    assert m_ref[~at_face].sum() > 1000 and (~m_ref[~at_face]).sum() > 1000
    print(f"points within 1e-6 of a face: {int(at_face.sum())}, of which on other sides: "
          f"{int((m_ours != m_ref).sum())}")
    assert torch.equal(TN.points_in_box(torch.from_numpy(xyz), w2b, half),
                       torch.from_numpy(m_ours))


def _compare_scenes(ours, ref):
    """scenario.pt within 1e-12 relative, every npz array bit for bit,
    every JPEG byte for byte, the same files."""
    files = sorted(os.path.relpath(os.path.join(d, f), ref)
                   for d, _, fs in os.walk(ref) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), ours)
                           for d, _, fs in os.walk(ours) for f in fs)
    for rel in files:
        a, b = os.path.join(ours, rel), os.path.join(ref, rel)
        if rel.endswith(".pt"):
            with open(a, "rb") as f, open(b, "rb") as g:
                tree_equal(pickle.load(f), pickle.load(g), rel, rel=1e-12)
        elif rel.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert x.files == y.files
                for k in y.files:
                    tree_equal(x[k], y[k], f"{rel}/{k}")
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel
    return files


@pytest.mark.parametrize("source", ["build_frame", "waymo_segment"])
def test_process_sequence_matches_jax(tmp_path, source, jnative):
    """process_sequence on the CPU against JAX's, field by field; the
    scenario also returned equal."""
    rec = tmp_path / "seq.tfrecord"
    if source == "build_frame":
        write_tfrecord(str(rec), [build_frame(i, 4) for i in range(4)])
    else:
        _segment(rec, 3)
    ref = JE.process_sequence(str(rec), str(tmp_path / "jax"))
    timings = {}
    ours = TE.process_sequence(str(rec), str(tmp_path / "port"), device="cpu", timings=timings)
    tree_equal(ours, ref, rel=1e-12)
    files = _compare_scenes(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert set(timings) == set(TE.ETL_STAGES)
    if source == "waymo_segment":
        assert sum(f.startswith("images/") for f in files) == 3 * 5
        assert sum(f.startswith("lidars/") for f in files) == 3 * 5
        top = np.load(tmp_path / "port" / "lidars" / "lidar_TOP" / "00000000.npz")
        assert 0 < top["ranges"].shape[1] < 16 * 200   # the pixels without a pose dropped
        assert ref["metas"]["dynamic_stats"]["Vehicle"]["n_dynamic"] == 3


def test_etl_math_matches_jax():
    """The float64 helpers on their own, against JAX's numpy."""
    rng = np.random.default_rng(1)
    rpy = rng.uniform(-0.5, 0.5, (40, 3))
    np.testing.assert_allclose(TE.rotation_rpy(*rpy.T).numpy(), JE.rotation_rpy(*rpy.T),
                               rtol=0, atol=1e-15)
    pm = rng.uniform(-1, 1, (5, 7, 6))
    np.testing.assert_allclose(TE._pixel_poses(pm).numpy(), JE._pixel_poses(pm), atol=1e-15)
    np.testing.assert_allclose(TE.compute_inclinations(-0.3, 0.1, 9).numpy(),
                               JE.compute_inclinations(-0.3, 0.1, 9), atol=1e-16)
    ext = CS._pose4(1.0, 0.5, 2.0, 0.3)
    incl = np.linspace(-0.4, 0.1, 6)
    np.testing.assert_allclose(TE.range_image_rays(6, 11, incl, ext).numpy(),
                               JE.range_image_rays(6, 11, incl, ext), atol=1e-15)
    v2w, c2v = CS._pose4(3, 4, 5, 0.2), CS._pose4(1, 0, 2, -0.1)
    np.testing.assert_allclose(TE.camera_to_world(v2w, c2v).numpy(),
                               JE.camera_to_world(v2w, c2v), atol=1e-14)
    o, d = rng.standard_normal((50, 3)), rng.standard_normal((50, 3))
    for a, b in zip(TE.lidar_frame_to_world(o, d, v2w), JE.lidar_frame_to_world(o, d, v2w)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-15, atol=1e-14)
    pp = TE._pixel_poses(pm.reshape(-1, 6)).numpy()
    for a, b in zip(TE.apply_rolling_shutter(o[:35], d[:35], pp, v2w, c2v),
                    JE.apply_rolling_shutter(o[:35], d[:35], pp, v2w, c2v)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-13, atol=1e-13)


def test_preprocess_cli_matches_jax(tmp_path):
    """`python -m mudg_tpu_torch preprocess --device cpu` over two
    sequences at -j 1 and at -j 2 (spawned workers): each scene equal to
    JAX's process_sequence."""
    root = tmp_path / "raw"
    root.mkdir()
    write_tfrecord(str(root / "segment-a_with_camera_labels.tfrecord"),
                   [build_frame(i, 3) for i in range(3)])
    _segment(root / "segment-b.tfrecord", 2)
    for j in ("1", "2"):
        out = tmp_path / f"out{j}"
        r = subprocess.run([sys.executable, "-m", "mudg_tpu_torch", "preprocess", "--root",
                            str(root), "--out_root", str(out), "-j", j, "--device", "cpu"],
                           capture_output=True, text=True, timeout=300, cwd=REPO)
        assert r.returncode == 0, r.stderr
        assert "done: 2 sequence(s)" in r.stdout
        for name in ("segment-a_with_camera_labels", "segment-b"):
            ref = tmp_path / f"jax_{name}"
            if not ref.exists():
                JE.process_sequence(str(root / f"{name}.tfrecord"), str(ref))
            _compare_scenes(str(out / name), str(ref))


def test_scene_reader_matches_jax(tmp_path):
    """SceneReader over a preprocessed five-camera scene: the same names,
    frames, cameras, images, lidar rays and paths as JAX's."""
    rec = _segment(tmp_path / "s.tfrecord", 2)
    TE.process_sequence(rec, str(tmp_path / "scene"), device="cpu")
    ours, ref = TS.SceneReader(str(tmp_path / "scene")), JS.SceneReader(str(tmp_path / "scene"))
    assert ours.camera_names == ref.camera_names and len(ref.camera_names) == 5
    assert ours.lidar_names() == ref.lidar_names() and len(ref.lidar_names()) == 5
    assert ours.n_frames() == ref.n_frames() == 2
    for cam in ref.camera_names:
        tree_equal(ours.camera(cam, 1), ref.camera(cam, 1))
        tree_equal(ours.image(cam, 0), ref.image(cam, 0))
    for lid in ref.lidar_names():
        tree_equal(ours.lidar_rays(lid, 1), ref.lidar_rays(lid, 1))
    for fn in ("image_path", "sparse_path", "depth_path"):
        assert getattr(ours, fn)("camera_FRONT", 3) == getattr(ref, fn)("camera_FRONT", 3)
    assert ours.sparse_path("camera_FRONT", 1, 2) == ref.sparse_path("camera_FRONT", 1, 2)


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    assert w.isOpened()
    rng = np.random.default_rng(2)
    for i in range(40):
        w.write(np.clip(rng.normal(i * 6, 20, (48, 64, 3)), 0, 255).astype(np.uint8))
    w.release()
    return path


@pytest.mark.parametrize("length,stride", [(8, 4), (16, 4)])   # (16, 4) shrinks the stride
def test_video_clip_dataset_matches_jax(clip_path, length, stride):
    """Three items at the same seed: the same strides, starts (so frames),
    captions and fps as JAX's; the frame readers equal."""
    kw = dict(captions=["road", "street"], video_length=length, resolution=(32, 40),
              frame_stride=stride, seed=5)
    ours, ref = TV.VideoClipDataset([clip_path] * 2, **kw), JV.VideoClipDataset([clip_path] * 2,
                                                                                  **kw)
    for i in range(3):
        tree_equal(ours[i], ref[i])
    assert TV.video_frame_count(clip_path) == JV.video_frame_count(clip_path) == 40
    tree_equal(TV.read_video_frames(clip_path, [3, 0, 3]), JV.read_video_frames(clip_path,
                                                                                 [3, 0, 3]))
