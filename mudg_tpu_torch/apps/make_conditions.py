"""Offline condition maps: sparse RGB and depth for real and virtual poses
(port of `mudg_tpu/apps/make_conditions.py`, stage 1 of MuDG).

Rebuild of `data_process/pipeline_process.py` + `tools/generate_sparse.py` +
`pipeline_depth.py` on the scatter-min splatting of `render/splat.py`, on
the card (`--device`, default cuda); the clouds are read, the objects placed
and hidden points removed on the host:

  per scene directory (the preprocess output layout):
    scenario.pt            pickled dict with observers (cameras: intr/c2w/hw)
    objects/background.ply aggregated static background cloud
    objects_info.pkl       per-object clouds + per-frame poses + visibility
    lidar_clouds/NNNNNNNN.ply  per-frame clouds (for --six_frame_depth)
  outputs (the JAX app's names):
    sparse/<cam>/NNNNNNNN.jpg (+ _mask.jpg), depth/<cam>/NNNNNNNN.npy
    virtual_sparse/, virtual_depth/ for the +-shift lateral poses (_1, _2)
    six_frames_depth/, six_frames_sparse/: six frames' clouds with
    hidden-point removal

Usage:
    python -m mudg_tpu_torch conditions --scene <dir> [--render_virtual] \
        [--six_frame_depth] [--emit_virtual_items items.txt] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def _load_scene(scene: str):
    with open(os.path.join(scene, "scenario.pt"), "rb") as f:
        return pickle.load(f)


def _camera_params(camera, index):
    hw = camera["data"]["hw"][index]
    K = np.asarray(camera["data"]["intr"][index], np.float32)
    c2w = np.asarray(camera["data"]["c2w"][index], np.float32)
    return int(hw[0]), int(hw[1]), K, c2w


def _objects(scene: str):
    from ..render import pointcloud as PC

    with open(os.path.join(scene, "objects_info.pkl"), "rb") as f:
        obj_info = pickle.load(f)
    return obj_info, (PC.object_visibility_table(obj_info) if obj_info else None)


def _f32(a, device):
    import torch

    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _to_uint8(color):
    return (np.clip(color, 0, 1) * 255).astype(np.uint8)


def render_scene_conditions(scene: str, cameras=("camera_FRONT",), *, virtual: bool = False,
                            shift: float = 2.0, limit_frames: int | None = None,
                            device="cuda"):
    """generate_dynamic_sparse / generate_virtual_dynamic_sparse: each
    frame's sparse color, object mask and depth, at the real pose or at the
    two poses shifted +-`shift` along the camera's x axis."""
    from ..render import pointcloud as PC
    from ..render import splat as SP
    from ..utils import media

    observers = _load_scene(scene)["observers"]
    n_frames = observers["lidar_TOP"]["n_frames"]
    if limit_frames:
        n_frames = min(n_frames, limit_frames)
    bg_xyz, bg_rgb, _ = PC.fetch_ply(os.path.join(scene, "objects", "background.ply"))
    bg_xyz, bg_rgb = _f32(bg_xyz, device), _f32(bg_rgb, device)
    obj_info, obj_vis = _objects(scene)
    sparse_root = os.path.join(scene, "virtual_sparse" if virtual else "sparse")
    depth_root = os.path.join(scene, "virtual_depth" if virtual else "depth")

    for cam_name in cameras:
        camera = observers[cam_name]
        cam_sparse = os.path.join(sparse_root, cam_name)
        cam_depth = os.path.join(depth_root, cam_name)
        os.makedirs(cam_sparse, exist_ok=True)
        os.makedirs(cam_depth, exist_ok=True)
        for index in range(n_frames):
            h, w, K, c2w = _camera_params(camera, index)
            if obj_info:
                obj_xyz, obj_rgb = PC.merge_objects_at_frame(obj_info, obj_vis, index)
            else:
                obj_xyz = np.array([[1000.0, 1000.0, 1000.0]], np.float32)
                obj_rgb = np.zeros((1, 3), np.float32)
            poses = SP.virtual_poses(c2w, shift=shift)[1:] if virtual else [c2w]
            for vi, pose in enumerate(poses):
                color, depth, mask = SP.render_sparse_frame(
                    bg_xyz, bg_rgb, _f32(obj_xyz, device), _f32(obj_rgb, device),
                    _f32(K, device), pose, height=h, width=w)
                stem = f"{index:08d}_{vi + 1}" if virtual else f"{index:08d}"
                media.save_image(os.path.join(cam_sparse, stem + ".jpg"),
                                 _to_uint8(color.cpu().numpy()))
                media.save_image(os.path.join(cam_sparse, stem + "_mask.jpg"),
                                 (mask.cpu().numpy().astype(np.uint8) * 255)[..., None]
                                 .repeat(3, -1))
                np.save(os.path.join(cam_depth, stem + ".npy"), depth.cpu().numpy())
            print(f"{cam_name} frame {index}: done")


def render_six_frame_depth(scene: str, cameras=("camera_FRONT",), *, window=(-2, 4),
                           hpr_radius: float = 1e5, limit_frames: int | None = None,
                           device="cuda"):
    """pipeline_depth.py: the per-frame clouds of frames [i - 2, i + 3] and
    the objects visible at i, hidden points removed from the camera center
    (host), splatted to six_frames_depth/ and six_frames_sparse/."""
    from ..render import pointcloud as PC
    from ..render import splat as SP
    from ..utils import media

    observers = _load_scene(scene)["observers"]
    n_frames = observers["lidar_TOP"]["n_frames"]
    if limit_frames:
        n_frames = min(n_frames, limit_frames)
    obj_info, obj_vis = _objects(scene)

    def load_frame_cloud(i):
        path = os.path.join(scene, "lidar_clouds", f"{i:08d}.ply")
        if os.path.exists(path):
            xyz, rgb, _ = PC.fetch_ply(path)
            return xyz, rgb
        return None

    for cam_name in cameras:
        camera = observers[cam_name]
        out_depth = os.path.join(scene, "six_frames_depth", cam_name)
        out_sparse = os.path.join(scene, "six_frames_sparse", cam_name)
        os.makedirs(out_depth, exist_ok=True)
        os.makedirs(out_sparse, exist_ok=True)
        for index in range(n_frames):
            h, w, K, c2w = _camera_params(camera, index)
            clouds, colors = [], []
            for off in range(window[0], window[1]):
                j = index + off
                res = load_frame_cloud(j) if 0 <= j < n_frames else None
                if res is not None:
                    clouds.append(res[0])
                    colors.append(res[1] if res[1] is not None else np.full_like(res[0], 0.5))
            if obj_info:
                oxyz, orgb = PC.merge_objects_at_frame(obj_info, obj_vis, index)
                clouds.append(oxyz.astype(np.float32))
                colors.append(orgb.astype(np.float32))
            if not clouds:
                continue
            xyz = np.concatenate(clouds, 0)
            rgb = np.concatenate(colors, 0)
            vis = PC.hidden_point_removal(xyz.astype(np.float64), c2w[:3, 3], radius=hpr_radius)
            color, depth = SP.splat_points(
                _f32(xyz[vis], device), _f32(rgb[vis], device), _f32(K, device),
                _f32(np.linalg.inv(c2w), device), height=h, width=w, point_size=2.5)
            np.save(os.path.join(out_depth, f"{index:08d}.npy"), depth.cpu().numpy())
            media.save_image(os.path.join(out_sparse, f"{index:08d}.jpg"),
                             _to_uint8(color.cpu().numpy()))
            print(f"{cam_name} six-frame depth {index}: done")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene", required=True)
    p.add_argument("--cameras", nargs="+", default=["camera_FRONT"])
    p.add_argument("--render_virtual", action="store_true")
    p.add_argument("--six_frame_depth", action="store_true")
    p.add_argument("--shift", type=float, default=2.0)
    p.add_argument("--limit_frames", type=int, default=None)
    p.add_argument("--emit_virtual_items", default=None, metavar="PATH",
                   help="after rendering, write the virtual-pose inference "
                        "item list (generate_virtual_item.py equivalent)")
    p.add_argument("--window", type=int, default=16,
                   help="item window length for --emit_virtual_items")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    cams = tuple(args.cameras)
    render_scene_conditions(args.scene, cams, limit_frames=args.limit_frames,
                            device=args.device)
    if args.render_virtual:
        render_scene_conditions(args.scene, cams, virtual=True, shift=args.shift,
                                limit_frames=args.limit_frames, device=args.device)
    if args.six_frame_depth:
        render_six_frame_depth(args.scene, cams, limit_frames=args.limit_frames,
                               device=args.device)
    if args.emit_virtual_items:
        from ..data.waymo import make_virtual_item_list, write_items

        items = make_virtual_item_list(args.scene, cams, window=args.window)
        write_items(args.emit_virtual_items, items)
        print(f"wrote {len(items)} virtual items -> {args.emit_virtual_items}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
