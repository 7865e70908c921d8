"""LiDAR point-cloud processing on the card: unprojection, colouring from
the cameras, box segmentation, object and background clouds.

Port of `mudg_tpu/render/lidar.py` (reference `data_process/tools/
process_lidar.py`). The points are tensors on their device; the small 4x4
inverses are taken on the host in numpy, as JAX's are, so the card and the
CPU start from the same matrices, and the projections are fixed sums of
elementwise float64 products (`data/waymo_etl.rotate_translate`), the same
bits on either device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.waymo_etl import rotate_translate
from ..utils import native


def rays_to_points(rays_o: torch.Tensor, rays_d: torch.Tensor, ranges: torch.Tensor,
                   max_range: float = 75.0):
    """World hit points of lidar rays, float32; drops non-returns (range <=
    0) and points beyond max_range. Returns (points, valid mask)."""
    valid = (ranges > 0) & (ranges < max_range)
    r = ranges[valid].to(rays_d.dtype)
    return (rays_o[valid] + rays_d[valid] * r[:, None]).float(), valid


def color_points_from_cameras(xyz: torch.Tensor, cameras: list[dict], default=(0.5, 0.5, 0.5)):
    """Per-point RGB by projecting into each camera and sampling its image
    (process_lidar.py:45-82). cameras: dicts with K (3, 3), c2w (4, 4) and
    image (H, W, 3; uint8 or float; numpy or a tensor). The first camera
    whose frustum holds a point colours it (the front camera first). The
    projection is float64; pixel indices truncate after the in-frame test; a
    camera's samples are divided by 255 when their own max is above 1.5.
    A camera with no point to colour colours none (numpy's max of an empty
    sample raises in the JAX function). Returns (rgb float32, coloured mask)."""
    n, dev = xyz.shape[0], xyz.device
    rgb = torch.tensor(default, dtype=torch.float32, device=dev).repeat(n, 1)
    colored = torch.zeros(n, dtype=torch.bool, device=dev)
    for cam in cameras:
        K = np.asarray(cam["K"], np.float64)
        img = cam["image"]
        img = torch.as_tensor(np.ascontiguousarray(img) if isinstance(img, np.ndarray) else img,
                              device=dev)
        h, w = img.shape[:2]
        p = rotate_translate(xyz, np.linalg.inv(np.asarray(cam["c2w"], np.float64)))
        z = p[:, 2]
        u = K[0, 0] * p[:, 0] / z + K[0, 2]
        v = K[1, 1] * p[:, 1] / z + K[1, 2]
        ok = (~colored) & (z > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        if not bool(ok.any()):
            continue
        ui = u[ok].long().clamp(0, w - 1)
        vi = v[ok].long().clamp(0, h - 1)
        c = img[vi, ui].float()
        if float(c.max()) > 1.5:
            c = c / 255.0
        rgb[ok] = c
        colored |= ok
    return rgb, colored


def box_world_to_box(transform_obj) -> np.ndarray:
    """world-to-box 4x4 of an object's box-to-world pose (host, float64)."""
    return np.linalg.inv(np.asarray(transform_obj, np.float64))


def segment_objects(xyz: torch.Tensor, rgb: torch.Tensor, objects_frame: list[dict]):
    """Split a frame's cloud into per-object point sets and a background
    mask. objects_frame: {id, transform_obj (4, 4 box -> world), size (3,)
    full extents}. Returns (per object {id, points in the BOX frame,
    colors, count}, background mask)."""
    bg_mask = torch.ones(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    out = []
    for obj in objects_frame:
        w2b = box_world_to_box(obj["transform_obj"]).astype(np.float32)
        half = np.asarray(obj["size"], np.float64) / 2.0
        inside = native.points_in_box(xyz, w2b, half)
        out.append({"id": obj["id"], "points": native.transform_points(xyz[inside], w2b),
                    "colors": rgb[inside], "count": int(inside.sum())})
        bg_mask &= ~inside
    return out, bg_mask


def is_object_moving(centers, thresh: float = 0.5) -> bool:
    """Displacement filter (process_lidar.py:265-280): moving when the box
    centre's bounding box over the clip has a diagonal above `thresh` m."""
    c = centers if isinstance(centers, torch.Tensor) else torch.as_tensor(
        np.asarray(centers, np.float64))
    if c.shape[0] < 2:
        return False
    return bool(torch.linalg.norm(c.amax(dim=0) - c.amin(dim=0)) > thresh)


def aggregate_object_cloud(per_frame_points: list, per_frame_colors: list, voxel: float = 0.05,
                           device=None):
    """A dynamic object's per-frame canonical clouds merged and voxel
    downsampled; empty float32 (0, 3) tensors when it has none."""
    if not per_frame_points:
        z = torch.zeros((0, 3), dtype=torch.float32, device=device)
        return z, z.clone()
    return native.voxel_downsample(torch.cat(per_frame_points), torch.cat(per_frame_colors),
                                   voxel)


def build_background_cloud(per_frame_points: list, per_frame_colors: list, voxel: float = 0.1,
                           device=None):
    """Background points over all frames, voxel downsampled
    (save_background_from_pt, process_lidar.py:212-262)."""
    return aggregate_object_cloud(per_frame_points, per_frame_colors, voxel, device)
