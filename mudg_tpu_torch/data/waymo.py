"""Waymo item lists and frame loading for the inference apps (host-side,
numpy): the part of `mudg_tpu/data/waymo.py` that `data/conditions.py`
needs. The training dataset (`WaymoDataset`, `BatchLoader`) waits for the
training slice. OpenCV is imported by the readers only.

Item lists are dict-per-line files ("frames" + per-modality base dirs);
dense frames load INTER_LINEAR, sparse conditions INTER_NEAREST; depth
.npy maps are replicated to 3 channels. Outputs are channels-last.
"""
from __future__ import annotations

import ast

import numpy as np

CLASS_LABELS = {"color": 0, "semantic": 1, "depth": 500, "normal": 1000}


def read_items(path: str) -> list[dict]:
    """Item lists are python-dict literals, one per line
    (data/create_data_infos.py:81-89)."""
    with open(path) as f:
        return [ast.literal_eval(line) for line in f if line.strip()]


def _imread_rgb(path: str, size_wh, nearest: bool) -> np.ndarray:
    import cv2

    data = np.fromfile(path, np.uint8)
    img = cv2.imdecode(data, cv2.IMREAD_ANYCOLOR)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.resize(img, size_wh, interpolation=interp)


def _load_depth_npy(path: str, size_wh) -> np.ndarray:
    import cv2

    d = np.load(path, allow_pickle=True)
    d = cv2.resize(d, size_wh, interpolation=cv2.INTER_LINEAR)
    return np.repeat(d[:, :, None], 3, axis=2)


def resize_center_crop(frames: np.ndarray, resolution) -> np.ndarray:
    """torchvision Resize(min_side) + CenterCrop equivalent on (T, H, W, C)."""
    th, tw = resolution
    t, h, w, c = frames.shape
    scale = min(th, tw) / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    if (nh, nw) != (h, w):
        import cv2

        frames = np.stack(
            [cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR) for f in frames]
        )
    top = max((nh - th) // 2, 0)
    left = max((nw - tw) // 2, 0)
    return frames[:, top : top + th, left : left + tw]
