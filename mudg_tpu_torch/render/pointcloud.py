"""Point-cloud host utilities: voxel downsampling, hidden-point removal,
PLY I/O and dynamic-object assembly (numpy and scipy, on the host).

Copy of what the port needs from `mudg_tpu/render/pointcloud.py`; the
numpy `voxel_downsample` also stands in for the JAX package's native
(C++) one, which computes the same centroids in another order.
"""
from __future__ import annotations

import numpy as np


def voxel_downsample(xyz: np.ndarray, rgb: np.ndarray | None, voxel: float):
    """Average points (and colors) per voxel cell: the centroid of each
    occupied voxel (Open3D voxel_down_sample semantics)."""
    if len(xyz) == 0:
        return xyz, rgb
    keys = np.floor(xyz / voxel).astype(np.int64)
    keys = keys - keys.min(axis=0)
    dims = keys.max(axis=0) + 1
    flat = (keys[:, 0] * dims[1] + keys[:, 1]) * dims[2] + keys[:, 2]
    uniq, inv, counts = np.unique(flat, return_inverse=True, return_counts=True)
    out_xyz = np.zeros((len(uniq), 3), np.float64)
    np.add.at(out_xyz, inv, xyz)
    out_xyz /= counts[:, None]
    out_rgb = None
    if rgb is not None:
        out_rgb = np.zeros((len(uniq), rgb.shape[1]), np.float64)
        np.add.at(out_rgb, inv, rgb)
        out_rgb /= counts[:, None]
        out_rgb = out_rgb.astype(rgb.dtype)
    return out_xyz.astype(xyz.dtype), out_rgb


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
