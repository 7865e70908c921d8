"""INRIA-format 3DGS PLY interop (port of `mudg_tpu/gs/io.py`, numpy).

One binary_little_endian vertex element with
    x y z nx ny nz f_dc_0..2 [f_rest_0..3K-1] opacity scale_0..2 rot_0..3
where opacity is the raw logit, scale_* the log-scales, rot_* the
unnormalized wxyz quaternion, f_dc = (rgb - 0.5) / C0, and f_rest the rest
SH coefficients flattened channel-major ((N, K, 3) -> transpose -> (N, 3K)),
as graphdeco gaussian-splatting's `save_ply` / `load_ply` write and read it.
"""
from __future__ import annotations

import numpy as np
import torch

from .gaussians import Gaussians

SH_C0 = 0.28209479177387814


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_gaussians_ply(path: str, g, active_only: bool = True) -> int:
    """Write Gaussians to an INRIA-layout PLY; returns the vertex count. The
    group and sem fields have no standard encoding and are not written."""
    means = _np(g.means).astype(np.float32)
    keep = _np(g.active).astype(bool) if active_only else np.ones(len(means), bool)
    means = means[keep]
    n = len(means)
    f_dc = (_np(g.colors).astype(np.float32)[keep] - 0.5) / SH_C0
    rest = None
    if g.sh is not None:
        sh = _np(g.sh).astype(np.float32)[keep]           # (n, K, 3)
        rest = sh.transpose(0, 2, 1).reshape(n, -1)      # channel-major (n, 3K)
    names = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
    if rest is not None:
        names += [f"f_rest_{i}" for i in range(rest.shape[1])]
    names += ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    rec = np.zeros(n, dtype=[(nm, "<f4") for nm in names])
    rec["x"], rec["y"], rec["z"] = means.T
    for c in range(3):
        rec[f"f_dc_{c}"] = f_dc[:, c]
    if rest is not None:
        for i in range(rest.shape[1]):
            rec[f"f_rest_{i}"] = rest[:, i]
    rec["opacity"] = _np(g.opacity).astype(np.float32)[keep]
    scales = _np(g.log_scales).astype(np.float32)[keep]
    rots = _np(g.quats).astype(np.float32)[keep]
    for c in range(3):
        rec[f"scale_{c}"] = scales[:, c]
    for c in range(4):
        rec[f"rot_{c}"] = rots[:, c]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property float {nm}\n" for nm in names)
              + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
    return n


def load_gaussians_ply(path: str, device="cpu") -> Gaussians:
    """Read an INRIA-layout PLY into Gaussians on `device` (all slots active)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    n = int(next(l.split()[2] for l in header if l.startswith("element vertex")))
    np_types = {"float": "<f4", "double": "<f8", "uchar": "u1"}
    props = [(l.split()[2], np_types[l.split()[1]]) for l in header if l.startswith("property")]
    rec = np.frombuffer(data[end:], dtype=props, count=n)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    means = np.stack([rec["x"], rec["y"], rec["z"]], -1)
    colors = np.stack([rec[f"f_dc_{c}"] for c in range(3)], -1) * SH_C0 + 0.5
    n_rest = sum(1 for nm, _ in props if nm.startswith("f_rest_"))
    sh = None
    if n_rest:
        rest = np.stack([rec[f"f_rest_{i}"] for i in range(n_rest)], -1)
        sh = rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)   # back to (n, K, 3)
    return Gaussians(
        means=t(means),
        log_scales=t(np.stack([rec[f"scale_{c}"] for c in range(3)], -1)),
        quats=t(np.stack([rec[f"rot_{c}"] for c in range(4)], -1)),
        opacity=t(rec["opacity"]),
        colors=t(colors),
        active=torch.ones(n, dtype=torch.bool, device=device),
        sh=None if sh is None else t(sh),
    )
