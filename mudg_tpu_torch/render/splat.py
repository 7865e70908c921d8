"""Z-buffered point splatting on the card, and novel-view camera poses
(port of `mudg_tpu/render/splat.py`).

Points are projected with OpenCV-convention intrinsics and extrinsics,
splatted with a square footprint of `point_size` pixels (GL_POINTS
semantics) and composited by two int32 scatter-min passes
(`scatter_reduce_(..., "amin")`): the first over the depth bits (positive
fp32 depths bitcast to int32 keep their order, so a plain int32 min is an
exact depth test), the second over the point indices among each pixel's
depth winners (the lowest index owns the pixel). A footprint target off the
image goes to pixel 0 with the neutral value, as JAX's `mode="drop"`
scatter keeps it out. Every tensor lives on the device of `xyz`; the 4x4
pose inverse is computed on the CPU, so the card and the CPU project with
the same matrix.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

ZNEAR = 1e-4   # generate_sparse.py:48
ZFAR = 200.0
INF_BITS = 0x7F800000   # +inf as int32 bits
NO_POINT = 2**30


def _camera_axis(xyz64, w64, w2c, i):
    """Camera coordinate i of fp32 points: x * r0 rounded to fp32, then two
    fused multiply-adds (the exact product added in fp64, rounded once to
    fp32), then + t in fp32, as XLA's CPU dot in the JAX package gives
    `xyz @ R.T + t`; never a TF32 product. fp64 holds each product of two
    fp32 exactly; the sum's double rounding can differ from a true fused
    multiply-add only in rare last-bit cases."""
    acc = (xyz64[:, 0] * w64[i, 0]).float()
    for k in (1, 2):
        acc = (xyz64[:, k] * w64[i, k] + acc.double()).float()
    return acc + w2c[i, 3]


def project_points(xyz, K, w2c):
    """World points (N, 3) -> pixel coordinates and depth (u, v, z), OpenCV
    convention; K (3, 3) intrinsics, w2c (4, 4) world-to-camera, fp32."""
    xyz64, w64 = xyz.double(), w2c.double()
    cam = [_camera_axis(xyz64, w64, w2c, i) for i in range(3)]
    zc = cam[2]
    zs = torch.where(zc.abs() < 1e-9, torch.full_like(zc, 1e-9), zc)
    u = K[0, 0] * cam[0] / zs + K[0, 2]
    v = K[1, 1] * cam[1] / zs + K[1, 2]
    return u, v, zc


def _footprint_offsets(point_size: float):
    """GL_POINTS square footprint: a point of size s covers s x s pixels
    (s rounded half to even, at least 1) centered on its position."""
    s = max(int(round(point_size)), 1)
    lo = -(s // 2)
    return tuple((dy, dx) for dy in range(lo, lo + s) for dx in range(lo, lo + s))


def _pixel(c, size: int):
    """Rounded (half to even) pixel index; far-off coordinates are clamped
    first, so that the int32 cast is defined (they stay off the image)."""
    return torch.round(c.clamp(-2.0 * size - 8, 2.0 * size + 8)).to(torch.int32)


def splat_points(xyz, rgb, K, w2c, *, height: int, width: int, point_size: float = 2.5):
    """Render points to (color (H, W, 3), depth (H, W)); rgb in [0, 1],
    empty pixels black with depth 0 (generate_sparse.py:51)."""
    dev = xyz.device
    n = xyz.shape[0]
    u, v, z = project_points(xyz, K, w2c)
    valid = (z > ZNEAR) & (z < ZFAR)
    ui, vi = _pixel(u, width), _pixel(v, height)
    depth_bits = z.clamp_min(0.0).float().view(torch.int32)
    inf = torch.full_like(depth_bits, INF_BITS)

    def targets():
        for dy, dx in _footprint_offsets(point_size):
            yy, xx = vi + dy, ui + dx
            ok = valid & (yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
            yield ok, torch.where(ok, yy * width + xx, 0).long()

    zbuf = torch.full((height * width,), INF_BITS, dtype=torch.int32, device=dev)
    for ok, flat in targets():
        zbuf.scatter_reduce_(0, flat, torch.where(ok, depth_bits, inf), "amin")
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    none = torch.full_like(idx, NO_POINT)
    ibuf = torch.full((height * width,), NO_POINT, dtype=torch.int32, device=dev)
    for ok, flat in targets():
        wins = ok & (depth_bits == zbuf[flat])
        ibuf.scatter_reduce_(0, flat, torch.where(wins, idx, none), "amin")
    hit = ibuf != NO_POINT
    win = torch.where(hit, ibuf, 0).long()
    color = torch.where(hit[:, None], rgb[win], 0.0)
    depth = torch.where(hit, zbuf.view(torch.float32), 0.0)
    return color.reshape(height, width, 3), depth.reshape(height, width)


def dilate_mask(mask, kernel: int = 5, iterations: int = 3):
    """Binary dilation by a kernel x kernel max-pool, `iterations` times
    (cv2.dilate, generate_sparse.py:100)."""
    m = mask.float()[None, None]
    for _ in range(iterations):
        m = F.max_pool2d(m, kernel, stride=1, padding=kernel // 2)
    return m[0, 0] > 0.5


def pose_inverse(c2w, device):
    """w2c of a camera-to-world pose, inverted in fp32 on the CPU and put on
    `device`."""
    return torch.linalg.inv(torch.as_tensor(c2w, dtype=torch.float32).cpu()).to(device)


def render_sparse_frame(bg_xyz, bg_rgb, obj_xyz, obj_rgb, K, c2w, *, height: int, width: int,
                        bg_point_size: float = 2.5, obj_point_size: float = 4.0):
    """A sparse-condition frame: the background and the dynamic objects
    merged through the dilated object mask (generate_sparse.py:10-113).
    Returns (color (H, W, 3) in [0, 1], depth (H, W), mask (H, W) bool)."""
    w2c = pose_inverse(c2w, bg_xyz.device)
    bg_color, bg_depth = splat_points(bg_xyz, bg_rgb, K, w2c, height=height, width=width,
                                      point_size=bg_point_size)
    obj_color, obj_depth = splat_points(obj_xyz, obj_rgb, K, w2c, height=height,
                                        width=width, point_size=obj_point_size)
    # the reference thresholds the uint8 jpg at > 0 on all channels
    # (generate_sparse.py:99): half a level in float
    mask = dilate_mask((obj_color > 0.5 / 255.0).all(dim=2))
    mf = mask.to(bg_color.dtype)
    color = bg_color * (1 - mf[:, :, None]) + obj_color * mf[:, :, None]
    depth = bg_depth * (1 - mf) + obj_depth * mf
    return color, depth, mask


def virtual_poses(c2w: np.ndarray, shift: float = 2.0, with_original: bool = True):
    """Laterally shifted novel-view camera poses: c2w @ T(+-shift along the
    camera x axis)."""
    out = [c2w] if with_original else []
    for direction in (-1.0, 1.0):
        v = np.eye(4, dtype=c2w.dtype)
        v[0, 3] += round(direction * shift, 4)
        out.append(c2w @ v)
    return out
