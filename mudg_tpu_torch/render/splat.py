"""Novel-view camera poses (copy of `mudg_tpu/render/splat.virtual_poses`)."""
from __future__ import annotations

import numpy as np


def virtual_poses(c2w: np.ndarray, shift: float = 2.0, with_original: bool = True):
    """Laterally shifted novel-view camera poses: c2w @ T(+-shift along the
    camera x axis)."""
    out = [c2w] if with_original else []
    for direction in (-1.0, 1.0):
        v = np.eye(4, dtype=c2w.dtype)
        v[0, 3] += round(direction * shift, 4)
        out.append(c2w @ v)
    return out
