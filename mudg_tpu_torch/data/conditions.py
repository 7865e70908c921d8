"""Inference-side condition loading (virtual_render/data_tools.py rebuild;
a copy of `mudg_tpu/data/conditions.py`).

Loads per-window dense targets + sparse RGB/depth conditions for the three
inference tasks. Semantics match data_tools.py:7-215: dense INTER_LINEAR,
sparse INTER_NEAREST, sparse frame 0 replaced by the dense color frame 0
(:40), depth .npy clamp[0,100] -> [-1,1] (:67-96), class labels color=0,
depth=500, semantic=1 (:61,153,212). Channels-last (T, H, W, 3) float32.
"""
from __future__ import annotations

import os

import numpy as np

from .waymo import (
    _imread_rgb, _load_depth_npy, resize_center_crop, CLASS_LABELS,
)


def _load_window(sample: dict, base_key: str, resolution, *, nearest=False,
                 depth=False, ext=None):
    h, w = resolution
    base = sample[base_key]
    frames = []
    # virtual-pose items override the frame names per base: the rendered
    # virtual conditions are suffixed {frame}_{pose}.jpg while the dense GT
    # keeps plain names (generate_virtual_item.py semantics)
    names = sample.get(base_key + "_frames", sample["frames"])
    for fr in names:
        name = fr if ext is None else fr[:-4] + ext
        path = os.path.join(base, name)
        if depth:
            frames.append(_load_depth_npy(path, (w, h)))
        else:
            frames.append(_imread_rgb(path, (w, h), nearest).astype(np.float32))
    return np.stack(frames)


def get_task_frames(sample: dict, task: str, resolution) -> dict:
    """One task's (dense, sparse) window + class label; data_tools.py
    get_{color,depth,semantic}_frames."""
    color_dense = _load_window(sample, "dense_color_base", resolution)
    sparse = _load_window(sample, "sparse_color_base", resolution, nearest=True)
    sparse[0] = color_dense[0]

    if task == "color":
        dense = color_dense
    elif task == "semantic":
        dense = _load_window(sample, "dense_semantic_base", resolution)
    elif task == "depth":
        dense = _load_window(sample, "dense_depth_base", resolution, depth=True,
                             ext=".npy")
    else:
        raise ValueError(task)

    dense = resize_center_crop(dense, resolution)
    sparse = resize_center_crop(sparse, resolution)
    if task == "depth":
        dense = (np.clip(dense, 0, 100) / 100.0 - 0.5) * 2
    else:
        dense = (dense / 255.0 - 0.5) * 2
    sparse = (sparse / 255.0 - 0.5) * 2
    return {
        "dense_frames": dense.astype(np.float32),
        "sparse_frames": sparse.astype(np.float32),
        "class_label": CLASS_LABELS[task],
    }


def get_sparse_depth(sample: dict, resolution) -> np.ndarray:
    """Sparse depth condition window (data_tools.py:67-96)."""
    d = _load_window(sample, "sparse_depth_base", resolution, depth=True, ext=".npy")
    d = resize_center_crop(d, resolution)
    return ((np.clip(d, 0, 100) / 100.0 - 0.5) * 2).astype(np.float32)
