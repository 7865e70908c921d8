"""Waymo Open Dataset ETL: tfrecord -> per-scene images, lidar rays and
scenario.

Port of `mudg_tpu/data/waymo_etl.py` (reference `data_process/
preprocess.py:31-533`). Records are framed and decoded on the host
(`utils/native.tfrecord_index`, the wire decoder `data/waymo_proto.py`,
zlib); the ray and pose math runs in float64 torch on `device`:

- the OpenCV <- Waymo camera conversion (preprocess.py:192-206): c2w = v2w
  @ c2v @ OPENCV_TO_WAYMO;
- lidar range image -> per-pixel ray directions in the sensor frame
  (preprocess.py:336-346): azimuth from the image width and the
  extrinsic's yaw, inclinations from the beam calibration (reversed);
- the TOP lidar's rolling-shutter compensation (preprocess.py:361-386): a
  pose per pixel, and the delta pose in the lidar frame applied to its
  rays (about 170k 4x4 products a frame).

The outputs are the JAX package's files and layout: images/camera_X/
{frame:08d}.jpg (the raw JPEG payload), lidars/lidar_X/{frame:08d}.npz
(rays_o, rays_d, ranges and, for TOP, dpose; float32) and scenario.pt (a
pickle of numpy arrays).
"""
from __future__ import annotations

import os

import numpy as np
import torch

# OpenCV camera (z forward, x right, y down) in the Waymo camera frame (x
# forward, z up, y left), preprocess.py:192-197
OPENCV_TO_WAYMO = np.array([
    [0, 0, 1, 0],
    [-1, 0, 0, 0],
    [0, -1, 0, 0],
    [0, 0, 0, 1],
], dtype=np.float64)

WAYMO_CAMERAS = ["camera_FRONT", "camera_FRONT_LEFT", "camera_FRONT_RIGHT",
                 "camera_SIDE_LEFT", "camera_SIDE_RIGHT"]
WAYMO_LIDARS = ["lidar_TOP", "lidar_FRONT", "lidar_SIDE_LEFT",
                "lidar_SIDE_RIGHT", "lidar_REAR"]
WAYMO_CLASSES = ["unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist"]


def _f64(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def camera_to_world(v2w, c2v) -> torch.Tensor:
    """OpenCV-convention camera-to-world (preprocess.py:199-206)."""
    v2w = _f64(v2w)
    return v2w @ _f64(c2v, v2w.device) @ _f64(OPENCV_TO_WAYMO, v2w.device)


def compute_inclinations(inclination_min: float, inclination_max: float, height: int,
                         device=None) -> torch.Tensor:
    """Uniform beam inclinations where no explicit calibration is given:
    bin centres between min and max, top row first (reversed, as
    preprocess.py:295)."""
    rel = (torch.arange(height, dtype=torch.float64, device=device) + 0.5) / height
    incl = inclination_min + rel * (inclination_max - inclination_min)
    return incl.flip(0)


def range_image_rays(height: int, width: int, inclinations, extrinsic) -> torch.Tensor:
    """Per-pixel unit ray directions in the SENSOR frame (Waymo convention:
    +x forward, z up, y left), (H, W, 3) float64 on the inclinations'
    device. Column 0 is at azimuth pi less the extrinsic's yaw, decreasing
    to -pi across the width."""
    incl = _f64(inclinations)
    dev = incl.device
    ext = _f64(extrinsic, dev)
    az_correction = torch.atan2(ext[1, 0], ext[0, 0])
    ratios = (torch.arange(width, dtype=torch.float64, device=dev).flip(0) + 0.5) / width
    azimuth = (ratios * 2 - 1) * np.pi - az_correction
    cos_az, sin_az = torch.cos(azimuth)[None, :], torch.sin(azimuth)[None, :]
    cos_in, sin_in = torch.cos(incl)[:, None], torch.sin(incl)[:, None]
    return torch.stack([cos_az * cos_in, sin_az * cos_in,
                        sin_in.expand(height, width)], dim=-1)


def apply_rolling_shutter(rays_o, rays_d, pixel_pose, frame_pose, extrinsic):
    """Per-pixel ego-motion compensation of the TOP lidar
    (preprocess.py:374-380): dpose = (frame_pose @ extr)^-1 @ pixel_pose @
    extr, applied to rays in the lidar frame. rays_o, rays_d (N, 3);
    pixel_pose (N, 4, 4) vehicle -> world at each pixel's capture time;
    frame_pose (4, 4); extrinsic (4, 4) lidar -> vehicle. Returns (o, d,
    dpose), float64 on pixel_pose's device."""
    pp = _f64(pixel_pose)
    dev = pp.device
    ext = _f64(extrinsic, dev)
    base = torch.linalg.inv(_f64(frame_pose, dev) @ ext)
    dpose = (base @ pp) @ ext
    rot, trans = dpose[:, :3, :3], dpose[:, :3, 3]
    o = (rot @ _f64(rays_o, dev)[:, :, None])[:, :, 0] + trans
    d = (rot @ _f64(rays_d, dev)[:, :, None])[:, :, 0]
    return o, d, dpose


def rotate_translate(x, m, translate: bool = True) -> torch.Tensor:
    """x (N, 3) @ m[:3, :3]^T (+ m[:3, 3]) in float64 as a fixed sum of
    elementwise products, ((m[i,0] x + m[i,1] y) + m[i,2] z) + m[i,3]: the
    same bits on the card and on the CPU."""
    x = _f64(x)
    m = _f64(m, x.device)
    out = (m[:3, 0] * x[:, 0:1] + m[:3, 1] * x[:, 1:2]) + m[:3, 2] * x[:, 2:3]
    return out + m[:3, 3] if translate else out


def lidar_frame_to_world(rays_o, rays_d, l2w):
    """Rays from the (shutter-compensated) lidar frame into the world, in
    float64 on the rays' device."""
    return rotate_translate(rays_o, l2w), rotate_translate(rays_d, l2w, translate=False)


def iter_tfrecord(path: str):
    """Raw record bytes of a tfrecord file."""
    from ..utils.native import tfrecord_index

    with open(path, "rb") as f:
        data = f.read()
    for off, ln in tfrecord_index(data):
        yield data[off:off + ln]


def iter_frames(tfrecord_path: str):
    """Waymo Frames decoded from a tfrecord by the wire decoder."""
    from . import waymo_proto as WP

    for rec in iter_tfrecord(tfrecord_path):
        yield WP.parse_frame(rec)


def rotation_rpy(roll, pitch, yaw) -> torch.Tensor:
    """R_z(yaw) @ R_y(pitch) @ R_x(roll) over any leading shape, (..., 3, 3)
    float64 (waymo transform_utils.get_rotation_matrix, preprocess.py:313-315)."""
    roll = _f64(roll)
    pitch, yaw = _f64(pitch, roll.device), _f64(yaw, roll.device)
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    rows = [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _pixel_poses(pose_mat) -> torch.Tensor:
    """(..., 6) [roll pitch yaw x y z] -> (..., 4, 4) homogeneous transforms
    (transform_utils.get_transform, preprocess.py:317-320)."""
    pm = _f64(pose_mat)
    T = torch.zeros((*pm.shape[:-1], 4, 4), dtype=torch.float64, device=pm.device)
    T[..., :3, :3] = rotation_rpy(pm[..., 0], pm[..., 1], pm[..., 2])
    T[..., :3, 3] = pm[..., 3:6]
    T[..., 3, 3] = 1.0
    return T


def _object_to_vehicle(box) -> np.ndarray:
    """Label box -> o2v transform (preprocess.py:443-452)."""
    c, s = np.cos(box.heading), np.sin(box.heading)
    return np.array([
        [c, -s, 0, box.center_x],
        [s, c, 0, box.center_y],
        [0, 0, 1, box.center_z],
        [0, 0, 0, 1.0],
    ])


# ---------------------------------------------------------------------------
# Dynamic-object statistics (data_process/tools/filter_dynamic.py:10-119)
# ---------------------------------------------------------------------------

def collect_loc_motion(frames):
    """Per-object xy world paths and inter-frame motion, and the ego path
    (filter_dynamic.py:10-38)."""
    categories: dict = {}
    ego_path = np.empty((3, 0))
    for frame in frames:
        v2w = np.asarray(frame.pose, np.float64)
        ego_path = np.concatenate([ego_path, v2w[:3, 3:]], axis=1)
        for label in frame.laser_labels:
            cat = categories.setdefault(WAYMO_CLASSES[int(label.type)], {})
            b = label.box
            loc = (v2w @ np.array([b.center_x, b.center_y, b.center_z, 1.0]))[:2]
            if label.id not in cat:
                cat[label.id] = dict(paths=[loc], motions=[0.0])
            else:
                d = cat[label.id]
                d["motions"].append(float(np.linalg.norm(d["paths"][-1] - loc)))
                d["paths"].append(loc)
    return categories, ego_path


def collect_box_speed(frames):
    """Per-object |v_xy| series from the label metadata (filter_dynamic.py:41-61)."""
    categories: dict = {}
    for frame in frames:
        for label in frame.laser_labels:
            cat = categories.setdefault(WAYMO_CLASSES[int(label.type)], {})
            m = label.metadata
            cat.setdefault(label.id, dict(motions=[]))["motions"].append(
                float(np.hypot(m.speed_x, m.speed_y)))
    return categories


def count_all(frames):
    """Per-object observation counts (filter_dynamic.py:64-81)."""
    categories: dict = {}
    for frame in frames:
        for label in frame.laser_labels:
            cat = categories.setdefault(WAYMO_CLASSES[int(label.type)], {})
            cat[label.id] = cat.get(label.id, -1) + 1
    return categories


def stat_dynamic_objects(frames, speed_eps=0.2, loc_eps=0.03):
    """Union of the speed and location motion filters
    (filter_dynamic.py:84-119). `frames` may be a list (iterated twice)."""
    frames = list(frames) if not isinstance(frames, (list, tuple)) else frames
    stats = {c: {"n_dynamic": 0, "is_dynamic": [], "by_speed": [], "by_loc": []}
             for c in WAYMO_CLASSES}
    for cls, cat in collect_box_speed(frames).items():
        stats[cls]["by_speed"] = [oid for oid, d in cat.items() if np.max(d["motions"]) > speed_eps]
    loc_stats, _ = collect_loc_motion(frames)
    for cls, cat in loc_stats.items():
        stats[cls]["by_loc"] = [oid for oid, d in cat.items() if np.max(d["motions"]) > loc_eps]
    for d in stats.values():
        dyn = sorted(set(d["by_speed"]) | set(d["by_loc"]))
        d["is_dynamic"] = dyn
        d["n_dynamic"] = len(dyn)
    return stats


# ---------------------------------------------------------------------------
# Full-sequence ETL
# ---------------------------------------------------------------------------

ETL_STAGES = ("read_decode", "rays", "npz", "images")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _lidar_rays(ri, pose_mat, c, extrinsic, frame_pose, world_offset, dev):
    """One lidar's npz arrays (float32, as the JAX ETL saves them) from its
    decoded range image ri (H, W, 4: range, intensity, elongation, NLZ) and,
    for TOP, its pose image (H, W, 6) or None."""
    hh, ww = ri.shape[:2]
    if c.beam_inclinations is not None and len(c.beam_inclinations):
        incl = _f64(np.asarray(c.beam_inclinations, np.float64)[::-1].copy(), dev)
    else:
        incl = compute_inclinations(c.beam_inclination_min, c.beam_inclination_max, hh, dev)
    ranges = torch.as_tensor(np.ascontiguousarray(ri[..., 0]), device=dev).double()
    rays_d = range_image_rays(hh, ww, incl, extrinsic)
    if pose_mat is not None:   # TOP: rolling-shutter compensation
        pose_mat = torch.as_tensor(pose_mat, device=dev)
        valid = (pose_mat != 0).all(dim=-1)
        pixel_pose = _pixel_poses(pose_mat[valid])
        pixel_pose[:, :3, 3] -= _f64(world_offset, dev)
        d_sel = rays_d[valid]
        o, d, dpose = apply_rolling_shutter(torch.zeros_like(d_sel), d_sel, pixel_pose,
                                            frame_pose, extrinsic)
        return dict(rays_o=_numpy(o[None].float()), rays_d=_numpy(d[None].float()),
                    ranges=_numpy(ranges[valid][None].float()),
                    dpose=_numpy(dpose[None].float()))
    return dict(rays_o=_numpy(torch.zeros_like(rays_d).float()), rays_d=_numpy(rays_d.float()),
                ranges=_numpy(ranges.float()))


def process_sequence(tfrecord_path: str, out_dir: str, *,
                     class_names=tuple(WAYMO_CLASSES),
                     should_offset_pos: bool = True,
                     should_offset_timestamp: bool = True,
                     save_images: bool = True,
                     save_lidar: bool = True,
                     device="cuda",
                     timings: dict | None = None) -> dict:
    """Full ETL of one Waymo sequence (preprocess.py:31-533), the ray and
    pose math on `device`. Writes out_dir/images/camera_X/{frame:08d}.jpg
    (the raw JPEG payloads), out_dir/lidars/lidar_X/{frame:08d}.npz and
    out_dir/scenario.pt in the reference's observer / object layout;
    returns the scenario dict. `timings`: a dict that gains the seconds
    spent in each of ETL_STAGES (reading the records and decoding them and
    their range and pose images, the ray math with its copies to and from
    the device, the npz writes, the JPEG writes)."""
    import pickle

    from ..utils.profiling import stage_clock
    from . import waymo_proto as WP

    dev = torch.device(device)

    def clock(stage):
        return stage_clock(timings, stage, dev)

    with clock("read_decode"):
        frames = list(iter_frames(tfrecord_path))
    if not frames:
        raise ValueError(f"no frames in {tfrecord_path}")
    frame0 = frames[0]

    world_offset = np.zeros(3)
    if should_offset_pos:
        world_offset = np.asarray(frame0.pose, np.float64)[:3, 3].copy()
    timestamp_offset = frame0.timestamp_micros / 1e6 if should_offset_timestamp else 0.0
    dynamic_stats = stat_dynamic_objects(frames)

    scene_observers: dict = {}
    scene_objects: dict = {}
    frame_timestamps = []
    os.makedirs(out_dir, exist_ok=True)

    for frame_ind, frame in enumerate(frames):
        frame_pose = np.asarray(frame.pose, np.float64).copy()
        frame_pose[:3, 3] -= world_offset
        frame_timestamp = frame.timestamp_micros / 1e6 - timestamp_offset
        frame_timestamps.append(frame_timestamp)
        pose_dev = _f64(frame_pose, dev)

        ego = scene_observers.setdefault(
            "ego_car", dict(class_name="EgoVehicle", n_frames=0,
                            data=dict(v2w=[], global_timestamps=[], global_frame_inds=[])))
        ego["n_frames"] += 1
        ego["data"]["v2w"].append(frame_pose)
        ego["data"]["global_timestamps"].append(frame_timestamp)
        ego["data"]["global_frame_inds"].append(frame_ind)

        # cameras (preprocess.py:150-231): the raw JPEG payload is written
        images_by_name = {im.name: im for im in frame.images}
        for c in frame.context.camera_calibrations:
            camera = images_by_name.get(c.name)
            if camera is None:
                continue
            str_id = "camera_" + WP.CAMERA_NAMES[c.name]
            cam_ts = camera.pose_timestamp - (timestamp_offset if should_offset_timestamp else 0.0)
            fx, fy, cx, cy, *distortion = c.intrinsic
            intr = np.eye(3)
            intr[0, 0], intr[1, 1] = fx, fy
            intr[0, 2], intr[1, 2] = cx, cy
            c2v = np.asarray(c.extrinsic, np.float64)
            v2w = np.asarray(camera.pose, np.float64).copy()
            v2w[:3, 3] -= world_offset
            with clock("rays"):
                c2w = _numpy(camera_to_world(_f64(v2w, dev), c2v))
                c2v_cv = _numpy(_f64(c2v, dev) @ _f64(OPENCV_TO_WAYMO, dev))

            obs = scene_observers.setdefault(
                str_id, dict(class_name="Camera", n_frames=0,
                             data=dict(hw=[], intr=[], distortion=[], c2v_0=[], c2v=[],
                                       sensor_v2w=[], c2w=[], global_timestamps=[],
                                       global_frame_inds=[])))
            obs["n_frames"] += 1
            d = obs["data"]
            d["hw"].append((c.height, c.width))
            d["intr"].append(intr)
            d["distortion"].append(np.asarray(distortion))
            d["c2v_0"].append(c2v)
            d["c2v"].append(c2v_cv)
            d["sensor_v2w"].append(v2w)
            d["c2w"].append(c2w)
            d["global_timestamps"].append(cam_ts)
            d["global_frame_inds"].append(frame_ind)

            if save_images and camera.image:
                with clock("images"):
                    img_dir = os.path.join(out_dir, "images", str_id)
                    os.makedirs(img_dir, exist_ok=True)
                    with open(os.path.join(img_dir, f"{frame_ind:08d}.jpg"), "wb") as f:
                        f.write(camera.image)

        # lidars (preprocess.py:236-413)
        lasers_by_name = {l.name: l for l in frame.lasers}
        for c in sorted(frame.context.laser_calibrations, key=lambda c: c.name):
            laser = lasers_by_name.get(c.name)
            if laser is None:
                continue
            str_id = "lidar_" + WP.LASER_NAMES[c.name]
            extrinsic = np.asarray(c.extrinsic, np.float64)
            with clock("rays"):
                l2w = _numpy(pose_dev @ _f64(extrinsic, dev))

            obs = scene_observers.setdefault(
                str_id, dict(class_name="RaysLidar", n_frames=0,
                             data=dict(l2v=[], l2w=[], global_timestamps=[],
                                       global_frame_inds=[])))
            obs["n_frames"] += 1
            d = obs["data"]
            d["l2v"].append(extrinsic)
            d["l2w"].append(l2w)
            d["global_timestamps"].append(frame_timestamp)
            d["global_frame_inds"].append(frame_ind)

            if not (save_lidar and laser.ri_return1 is not None):
                continue
            with clock("read_decode"):
                ri = laser.ri_return1.matrix()
                pose_blob = laser.ri_return1.range_image_pose_compressed
                pose_mat = (WP.decode_compressed_matrix(pose_blob)
                            if c.name == 1 and pose_blob else None)
            with clock("rays"):
                arrays = _lidar_rays(ri, pose_mat, c, extrinsic, frame_pose, world_offset, dev)
            with clock("npz"):
                lidar_dir = os.path.join(out_dir, "lidars", str_id)
                os.makedirs(lidar_dir, exist_ok=True)
                np.savez_compressed(os.path.join(lidar_dir, f"{frame_ind:08d}.npz"), **arrays)

        # objects (preprocess.py:415-468)
        for label in frame.laser_labels:
            cls = WAYMO_CLASSES[int(label.type)]
            if cls not in class_names:
                continue
            obj = scene_objects.setdefault(
                str(label.id), dict(id=label.id, class_name=cls, frame_annotations=[]))
            pose = frame_pose @ _object_to_vehicle(label.box)
            dimension = [label.box.length, label.box.width, label.box.height]
            obj["frame_annotations"].append([[frame_ind, frame_timestamp], [pose, dimension]])

    n_global_frames = len(frames)
    for odict in scene_observers.values():
        odict["data"] = {k: np.array(v) for k, v in odict["data"].items()}

    # contiguous frame runs -> segments (preprocess.py:478-512)
    for odict in scene_objects.values():
        annos = odict.pop("frame_annotations")
        segments = []
        cur = None
        for i, ((find, fts), (pose, dim)) in enumerate(annos):
            if i == 0 or find - annos[i - 1][0][0] != 1:
                cur = dict(start_frame=find, n_frames=None, data=dict(
                    transform=[], scale=[], global_timestamps=[], global_frame_inds=[]))
            cd = cur["data"]
            cd["transform"].append(pose)
            cd["scale"].append(dim)
            cd["global_timestamps"].append(fts)
            cd["global_frame_inds"].append(find)
            if i == len(annos) - 1 or annos[i + 1][0][0] - find != 1:
                cur["data"] = {k: np.array(v) for k, v in cd.items()}
                cur["n_frames"] = find - cur["start_frame"] + 1
                segments.append(cur)
        odict["n_full_frames"] = n_global_frames
        odict["segments"] = segments

    scenario = dict(
        scene_id=frame0.context.name,
        metas=dict(n_frames=n_global_frames, world_offset=world_offset,
                   timestamp_offset=timestamp_offset,
                   frame_timestamps=np.array(frame_timestamps),
                   dynamic_stats=dynamic_stats),
        objects=scene_objects,
        observers=scene_observers,
    )
    with open(os.path.join(out_dir, "scenario.pt"), "wb") as f:
        pickle.dump(scenario, f)
    return scenario
