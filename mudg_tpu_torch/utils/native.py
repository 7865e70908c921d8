"""The data pipeline's point and record primitives: TFRecord framing, voxel
downsampling, rigid point transforms and oriented box tests.

Port of `mudg_tpu/utils/native.py` and the C++ it binds
(`native/mudg_native.cpp`). The framing is one Python pass over a file's
records (a few hundred a Waymo segment). The three point ops are torch ops
on their input's device: on the card for the ETL's per-frame and per-segment
clouds. No C++ library is built, so nothing falls back.

Each point op mirrors the C++ arithmetic:
- `voxel_downsample`: the cell of a point is floor(float64(x) *
  (1.0 / float64(float32(voxel)))) per axis (mudg_native.cpp:59-63); points
  and colours are summed per cell in float64 and divided by the count
  (:67-88). The rows come out sorted by cell (x, then y, then z), where the
  C++ returns them in its hash map's order, which is not defined.
- `transform_points` and `points_in_box`: float32 products and sums in the
  C++ order, m[0] x + m[1] y + m[2] z + m[3] (:104-106, :128-130). The C++
  is built with -march=native and may fuse them into multiply-adds, so a
  point within about 1e-6 of a box face may fall on either side.
"""
from __future__ import annotations

import numpy as np
import torch


def tfrecord_index(data: bytes) -> list[tuple[int, int]]:
    """(offset, length) of every record in a TFRecord byte buffer: records
    are [u64 length][u32 length crc][data][u32 data crc], CRCs skipped
    (waymo_filereader.py:40-66); a truncated tail record ends the scan."""
    out = []
    pos, size = 0, len(data)
    while pos + 12 <= size:
        length = int.from_bytes(data[pos:pos + 8], "little")
        payload = pos + 12
        if payload + length + 4 > size:
            break
        out.append((payload, length))
        pos = payload + length + 4
    return out


def _as_tensor(a, device=None, dtype=None):
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=dtype or a.dtype)
    return torch.as_tensor(np.ascontiguousarray(a), device=device, dtype=dtype)


def voxel_cells(xyz: torch.Tensor, voxel: float) -> torch.Tensor:
    """(N, 3) int64 cell of each float32 point, as mudg_native.cpp:59-63
    picks it."""
    inv = 1.0 / float(np.float32(voxel))
    return torch.floor(xyz.double() * inv).long()


def voxel_downsample(xyz, rgb, voxel: float):
    """The centroid of the points (and colours) in each occupied voxel.

    xyz (N, 3) and rgb (N, C) or None: tensors (on any device) or numpy
    arrays. Points are taken as float32, as the C++ takes them. Returns
    (xyz float32 (M, 3), rgb (M, C) in rgb's dtype or None), one row per
    occupied cell, sorted by cell, on xyz's device; numpy in, numpy out.
    No points: the inputs as they are."""
    was_numpy = not isinstance(xyz, torch.Tensor)
    if len(xyz) == 0:
        return xyz, rgb
    pts = _as_tensor(xyz, dtype=torch.float32)
    cells = voxel_cells(pts, voxel)
    lo = cells.amin(dim=0)
    cells = cells - lo
    dims = cells.amax(dim=0) + 1
    flat = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    _, inv, counts = torch.unique(flat, sorted=True, return_inverse=True, return_counts=True)
    n = counts.shape[0]
    cnt = counts.double()[:, None]
    sums = torch.zeros(n, 3, dtype=torch.float64, device=pts.device).index_add_(
        0, inv, pts.double())
    out_xyz = (sums / cnt).float()
    out_rgb = None
    if rgb is not None:
        col = _as_tensor(rgb, device=pts.device)
        csum = torch.zeros(n, col.shape[1], dtype=torch.float64, device=pts.device).index_add_(
            0, inv, col.float().double())
        # the C++ writes float32, which the JAX wrapper casts to rgb's dtype
        out_rgb = (csum / cnt).float().to(col.dtype)
    if was_numpy:
        return out_xyz.cpu().numpy(), (None if out_rgb is None else out_rgb.cpu().numpy())
    return out_xyz, out_rgb


def _affine_f32(xyz: torch.Tensor, mat) -> torch.Tensor:
    """out_i = ((m[i,0] x + m[i,1] y) + m[i,2] z) + m[i,3] in float32, the
    C++ order of operations (no fused multiply-add)."""
    m = _as_tensor(mat, device=xyz.device, dtype=torch.float32)
    x, y, z = xyz[:, 0:1], xyz[:, 1:2], xyz[:, 2:3]
    r = m[:3]
    return ((r[:, 0] * x + r[:, 1] * y) + r[:, 2] * z) + r[:, 3]


def transform_points(xyz, mat):
    """xyz @ R^T + t with a 4x4 matrix, in float32 on xyz's device; numpy
    in, numpy out."""
    was_numpy = not isinstance(xyz, torch.Tensor)
    out = _affine_f32(_as_tensor(xyz, dtype=torch.float32), mat)
    return out.cpu().numpy() if was_numpy else out


def points_in_box(xyz, w2b, half_extents):
    """Boolean mask of the points inside an oriented box: w2b the
    world-to-box 4x4, half_extents (hx, hy, hz); inside when -h <= b <= h on
    every axis, in float32 (mudg_native.cpp:124-135). numpy in, numpy out."""
    was_numpy = not isinstance(xyz, torch.Tensor)
    b = _affine_f32(_as_tensor(xyz, dtype=torch.float32), w2b)
    h = torch.tensor([float(v) for v in half_extents], dtype=torch.float32, device=b.device)
    mask = ((b >= -h) & (b <= h)).all(dim=1)
    return mask.cpu().numpy() if was_numpy else mask
