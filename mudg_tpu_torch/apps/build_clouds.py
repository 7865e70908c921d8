"""Scene point clouds: lidar rays -> coloured world points -> canonical
clouds of the moving objects and a static background cloud.

Port of `mudg_tpu/apps/build_clouds.py` (the first stage of
`data_process/pipeline_process.py:30-36`: `tools/process_lidar.py
save_object_from_pt` :141-209 and `save_background_from_pt` :212-262). Per
frame, on --device (default cuda): the TOP lidar's (shutter-compensated)
rays unprojected to world points, coloured by projecting them into the
surround cameras, moving Vehicle / Pedestrian boxes carved out into
canonical per-object clouds; then the rest voxel downsampled into
objects/background.ply. The JPEGs are decoded on the host (OpenCV), the
PLYs written there. Writes

    <scene>/objects/background.ply      voxel-downsampled static cloud
    <scene>/objects/<obj_id>.ply        per moving object, box frame
    <scene>/lidar_clouds/NNNNNNNN.ply   per-frame background cloud (read by
                                        make_conditions' six-frame depth)
    <scene>/objects_info.pkl            [{id, class_name, visibility (F,),
                                          bbox (F, 3), transform_obj (F, 4, 4),
                                          point_cloud{points, colors}}]

which is what `conditions` and `refine-gs` read.

Usage:
    python -m mudg_tpu_torch.apps.build_clouds --scene <dir> [--voxel_bg 0.1] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

DEFAULT_CAMERAS = (
    "camera_FRONT", "camera_FRONT_LEFT", "camera_FRONT_RIGHT",
    "camera_SIDE_LEFT", "camera_SIDE_RIGHT",
)
# what build_scene_clouds' `timings` splits its seconds into
STAGES = ("read", "decode", "project_color", "segment", "voxel", "ply")


def flatten_objects(scenario: dict, classes=("Vehicle", "Pedestrian")):
    """scenario.pt objects (per-segment runs, waymo_etl.py) -> per-object
    dense (F, 4, 4) transforms, (F, 3) box extents and (F,) visibility
    (save_object_from_pt:159-175)."""
    n_frames = scenario["metas"]["n_frames"]
    out = []
    for key, obj in scenario["objects"].items():
        if obj.get("class_name") not in classes:
            continue
        transform = np.tile(np.eye(4), (n_frames, 1, 1))
        bbox = np.zeros((n_frames, 3))
        vis = np.zeros(n_frames, np.int64)
        for seg in obj["segments"]:
            s, nf = seg["start_frame"], seg["n_frames"]
            transform[s:s + nf] = seg["data"]["transform"]
            bbox[s:s + nf] = seg["data"]["scale"]
            vis[s:s + nf] = 1
        out.append(dict(id=obj.get("id", key), class_name=obj["class_name"],
                        visibility=vis, bbox=bbox, transform_obj=transform))
    return out


def _frame_cameras(scene: str, observers: dict, cameras, index: int):
    """Camera dicts (K, c2w, image RGB uint8) for
    render/lidar.color_points_from_cameras, the front camera first
    (process_lidar.py:45); a camera without its image is left out."""
    from ..utils import media

    cams = []
    for name in cameras:
        cam = observers.get(name)
        if cam is None:
            continue
        try:
            img = media.imread(os.path.join(scene, "images", name, f"{index:08d}.jpg"))
        except FileNotFoundError:
            continue
        cams.append(dict(K=np.asarray(cam["data"]["intr"][index], np.float64),
                         c2w=np.asarray(cam["data"]["c2w"][index], np.float64),
                         image=np.ascontiguousarray(img[..., ::-1])))   # BGR -> RGB
    return cams


def build_scene_clouds(
    scene: str,
    *,
    cameras=DEFAULT_CAMERAS,
    sensor: str = "lidar_TOP",
    voxel_obj: float = 0.05,
    voxel_bg: float = 0.1,
    max_range: float = 75.0,
    motion_thresh: float = 0.5,
    limit_frames: int | None = None,
    device="cuda",
    timings: dict | None = None,
):
    """save_object_from_pt + save_background_from_pt on `device`. Returns
    the objects_info list (also pickled to <scene>/objects_info.pkl), whose
    clouds are numpy. `timings`: a dict that gains the seconds spent in each
    of STAGES (npz reads, JPEG decodes, projection and colour, box
    segmentation, voxel downsampling, PLY writes), the device synchronized
    at each stage's end."""
    import torch

    from ..data.waymo_etl import lidar_frame_to_world
    from ..render import lidar as L
    from ..render import pointcloud as PC
    from ..utils.profiling import stage_clock

    dev = torch.device(device)

    def clock(stage):
        return stage_clock(timings, stage, dev)

    def u8(rgb):
        return (rgb.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()

    with open(os.path.join(scene, "scenario.pt"), "rb") as f:
        scenario = pickle.load(f)
    observers = scenario["observers"]
    lidar = observers[sensor]
    n_frames = lidar["n_frames"]
    if limit_frames:
        n_frames = min(n_frames, limit_frames)

    # the motion filter: static objects stay in the background
    # (is_object_motion, process_lidar.py:265-280)
    moving = [o for o in flatten_objects(scenario)
              if L.is_object_moving(o["transform_obj"][o["visibility"] > 0][:, :3, 3],
                                    motion_thresh)]

    bg_pts, bg_rgb = [], []
    obj_pts = {o["id"]: [] for o in moving}
    obj_rgb = {o["id"]: [] for o in moving}
    cloud_dir = os.path.join(scene, "lidar_clouds")

    for index in range(n_frames):
        path = os.path.join(scene, "lidars", sensor, f"{index:08d}.npz")
        if not os.path.exists(path):
            continue
        with clock("read"):
            with np.load(path) as data:
                rays_o = torch.as_tensor(data["rays_o"].reshape(-1, 3), device=dev)
                rays_d = torch.as_tensor(data["rays_d"].reshape(-1, 3), device=dev)
                ranges = torch.as_tensor(data["ranges"].reshape(-1), device=dev)
        with clock("decode"):
            cams = _frame_cameras(scene, observers, cameras, index)
        with clock("project_color"):
            l2w = np.asarray(lidar["data"]["l2w"][index], np.float64)
            rays_o, rays_d = lidar_frame_to_world(rays_o, rays_d, l2w)
            xyz, _ = L.rays_to_points(rays_o, rays_d, ranges, max_range)
            rgb, colored = L.color_points_from_cameras(xyz, cams)
            # the reference keeps only camera-covered points (process_lidar.py:240-242)
            xyz, rgb = xyz[colored], rgb[colored]
        with clock("segment"):
            frame_objs = [dict(id=o["id"], transform_obj=o["transform_obj"][index],
                               size=o["bbox"][index])
                          for o in moving if o["visibility"][index]]
            segs, bg_mask = L.segment_objects(xyz, rgb, frame_objs)
            for s in segs:
                if s["count"]:
                    obj_pts[s["id"]].append(s["points"])
                    obj_rgb[s["id"]].append(s["colors"])
            bg_pts.append(xyz[bg_mask])
            bg_rgb.append(rgb[bg_mask])
        # the per-frame cloud of the six-frame depth window (pipeline_depth.py)
        with clock("ply"):
            os.makedirs(cloud_dir, exist_ok=True)
            if bool(bg_mask.any()):
                PC.store_ply(os.path.join(cloud_dir, f"{index:08d}.ply"),
                             bg_pts[-1].cpu().numpy(), u8(bg_rgb[-1]))

    obj_dir = os.path.join(scene, "objects")
    os.makedirs(obj_dir, exist_ok=True)
    obj_info = []
    for o in moving:
        with clock("voxel"):
            pts, rgb = L.aggregate_object_cloud(obj_pts[o["id"]], obj_rgb[o["id"]], voxel_obj, dev)
        o["point_cloud"] = dict(points=pts.cpu().numpy(), colors=rgb.cpu().numpy())
        obj_info.append(o)
        if len(pts):
            with clock("ply"):
                PC.store_ply(os.path.join(obj_dir, f"{o['id']}.ply"), o["point_cloud"]["points"],
                             u8(rgb))
    with clock("voxel"):
        xyz, rgb = L.build_background_cloud(bg_pts, bg_rgb, voxel_bg, dev)
    with clock("ply"):
        PC.store_ply(os.path.join(obj_dir, "background.ply"), xyz.cpu().numpy(), u8(rgb))
    with open(os.path.join(scene, "objects_info.pkl"), "wb") as f:
        pickle.dump(obj_info, f)
    print(f"[build_clouds] {scene}: background {len(xyz)} pts, "
          f"{len(obj_info)} moving objects")
    return obj_info


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", required=True)
    p.add_argument("--cameras", nargs="*", default=list(DEFAULT_CAMERAS))
    p.add_argument("--voxel_obj", type=float, default=0.05)
    p.add_argument("--voxel_bg", type=float, default=0.1)
    p.add_argument("--max_range", type=float, default=75.0)
    p.add_argument("--limit_frames", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    a = p.parse_args(argv)
    build_scene_clouds(a.scene, cameras=tuple(a.cameras), voxel_obj=a.voxel_obj,
                       voxel_bg=a.voxel_bg, max_range=a.max_range,
                       limit_frames=a.limit_frames, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
