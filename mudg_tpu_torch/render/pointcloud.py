"""Point-cloud utilities: voxel downsampling, hidden-point removal, PLY
I/O, dynamic-object assembly, the COLMAP reader and the SfM + LiDAR merge.

Port of `mudg_tpu/render/pointcloud.py`; host numpy and scipy but for
`voxel_downsample`, which is `utils/native.voxel_downsample` (the cells as
the JAX package's native library picks them; torch ops on the input's
device).
"""
from __future__ import annotations

import numpy as np

from ..utils.native import voxel_downsample  # noqa: F401  (this module's API, as in JAX)


def hidden_point_removal(xyz: np.ndarray, camera: np.ndarray, radius: float = 1e5):
    """Katz et al. spherical flip + convex hull visibility (Open3D
    hidden_point_removal, pipeline_depth.py:123). Returns the sorted indices
    of the visible points."""
    from scipy.spatial import ConvexHull

    p = xyz - camera[None, :]
    norm = np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-9)
    flipped = p + 2 * (radius - norm) * (p / norm)
    pts = np.concatenate([flipped, np.zeros((1, 3))], axis=0)  # the camera at the origin
    hull = ConvexHull(pts)
    return np.sort(np.setdiff1d(hull.vertices, [len(pts) - 1]))


def object_visibility_table(obj_info: list[dict]) -> np.ndarray:
    """(frames, n_objects) visibility matrix from the per-object records."""
    return np.stack([obj["visibility"] for obj in obj_info], axis=0).T


def merge_objects_at_frame(obj_info: list[dict], obj_vis: np.ndarray, frame: int):
    """Every object visible at `frame`, its canonical cloud moved into the
    world by its pose there: (xyz (N, 3), rgb (N, 3)); one far-away black
    point when none is visible (generate_sparse.py:226-260)."""
    xs, cs = [], []
    for index, visible in enumerate(obj_vis[frame]):
        if visible == 1:
            obj = obj_info[index]
            tf = obj["transform_obj"][frame]
            xs.append(obj["point_cloud"]["points"] @ tf[:3, :3].T + tf[:3, 3])
            cs.append(obj["point_cloud"]["colors"])
    if not xs:
        return np.array([[1000.0, 1000.0, 1000.0]]), np.array([[0.0, 0.0, 0.0]])
    return np.concatenate(xs, axis=0), np.concatenate(cs, axis=0)


def store_ply(path: str, xyz: np.ndarray, rgb_uint8: np.ndarray):
    """Write a binary PLY with x, y, z, nx, ny, nz, red, green, blue."""
    n = len(xyz)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property float nx\nproperty float ny\nproperty float nz\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "end_header\n")
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz.astype(np.float32).T
    rec["red"], rec["green"], rec["blue"] = rgb_uint8.astype(np.uint8).T
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def fetch_ply(path: str):
    """Read a binary or ascii PLY -> (xyz float32 (N, 3), rgb float32 in
    [0, 1] (N, 3) or None, normals or None)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    body = data[end:]
    fmt = next(l.split()[1] for l in header if l.startswith("format"))
    n = int(next(l.split()[2] for l in header if l.startswith("element vertex")))
    props = [tuple(l.split()[1:3][::-1]) for l in header if l.startswith("property")]
    np_types = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
                "short": "<i2", "ushort": "<u2", "char": "i1"}
    if fmt == "ascii":
        rows = np.loadtxt([l for l in body.decode().splitlines() if l.strip()][:n])
        table = {name: rows[:, i] for i, (name, _) in enumerate(props)}
    else:
        rec = np.frombuffer(body, dtype=[(name, np_types[typ]) for name, typ in props], count=n)
        table = {name: rec[name] for name, _ in props}
    xyz = np.stack([table["x"], table["y"], table["z"]], axis=1).astype(np.float32)
    rgb = None
    if "red" in table:
        rgb = np.stack([table["red"], table["green"], table["blue"]], axis=1).astype(np.float32)
        if rgb.max() > 1.0:
            rgb = rgb / 255.0
    normals = None
    if "nx" in table:
        normals = np.stack([table["nx"], table["ny"], table["nz"]], axis=1).astype(np.float32)
    return xyz, rgb, normals


def read_colmap_points3d_bin(path: str):
    """COLMAP points3D.bin reader (tools/merge_points.py:48-76; colmap
    Reconstruction::ReadPoints3DBinary: u64 count, then per point [u64 id,
    3x f64 xyz, 3x u8 rgb, f64 error, u64 track_len, track_len x (i32
    image_id, i32 point2D_idx)]). Returns (xyz (N, 3) f64, rgb (N, 3) u8,
    error (N,) f64)."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    xyz = np.empty((n, 3))
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n)
    head = struct.Struct("<QdddBBBdQ")
    for i in range(n):
        vals = head.unpack_from(data, off)
        off += head.size
        xyz[i] = vals[1:4]
        rgb[i] = vals[4:7]
        err[i] = vals[7]
        off += 8 * vals[8]   # the (image_id, point2D_idx) track
    return xyz, rgb, err


def merge_sfm_lidar(out_path: str, colmap_bin: str, lidar_ply: str):
    """COLMAP SfM points appended to the LiDAR cloud, written to out_path
    (tools/merge_points.py:79-93). Returns the merged (xyz, rgb in [0, 1])."""
    sfm_xyz, sfm_rgb, _ = read_colmap_points3d_bin(colmap_bin)
    lidar_xyz, lidar_rgb01, _ = fetch_ply(lidar_ply)
    xyz = np.concatenate([lidar_xyz.astype(np.float64), sfm_xyz], axis=0)
    rgb01 = np.concatenate([lidar_rgb01, sfm_rgb.astype(np.float32) / 255.0], axis=0)
    store_ply(out_path, xyz.astype(np.float32), (rgb01 * 255).astype(np.uint8))
    return xyz, rgb01
