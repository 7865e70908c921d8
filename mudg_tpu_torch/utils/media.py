"""Media I/O and visualization: the image reader, PNG and mp4 writers, the
semantic palette, the Spectral depth colormap (a copy of
`mudg_tpu/utils/media.py`). cv2 is imported by the reader and the writers
only, so the rest runs where OpenCV is not installed."""
from __future__ import annotations

import os

import numpy as np

# cityscapes-style 21-color LUT; the MDM decodes against the first 19 entries
SEMANTIC_PALETTE = np.array([
    [255, 120, 50], [255, 192, 203], [255, 255, 0], [0, 150, 245],
    [0, 255, 255], [255, 127, 0], [255, 0, 0], [255, 240, 150],
    [135, 60, 0], [160, 32, 240], [255, 0, 255], [139, 137, 137],
    [75, 0, 75], [150, 240, 80], [230, 230, 250], [0, 175, 0],
    [0, 255, 127], [222, 155, 161], [140, 62, 69], [227, 164, 30],
    [0, 128, 0],
], dtype=np.uint8)

# matplotlib Spectral anchors (eval_tools.py:170-182)
_SPECTRAL = np.array([
    (0.6196078431372549, 0.00392156862745098, 0.25882352941176473),
    (0.8352941176470589, 0.24313725490196078, 0.30980392156862746),
    (0.9568627450980393, 0.42745098039215684, 0.2627450980392157),
    (0.9921568627450981, 0.6823529411764706, 0.3803921568627451),
    (0.996078431372549, 0.8784313725490196, 0.5450980392156862),
    (1.0, 1.0, 0.7490196078431373),
    (0.9019607843137255, 0.9607843137254902, 0.596078431372549),
    (0.6705882352941176, 0.8666666666666667, 0.6431372549019608),
    (0.4, 0.7607843137254902, 0.6470588235294118),
    (0.19607843137254902, 0.5333333333333333, 0.7411764705882353),
    (0.3686274509803922, 0.30980392156862746, 0.6352941176470588),
])


def spectral_colormap(image: np.ndarray, reverse: bool = False) -> np.ndarray:
    """Map values in [0,1] to Spectral RGB floats (eval_tools method_custom)."""
    cmap = _SPECTRAL[::-1] if reverse else _SPECTRAL
    k = len(cmap)
    pos = np.clip(image, 0, 1) * (k - 1)
    left = pos.astype(np.int64)
    right = np.clip(left + 1, 0, k - 1)
    d = (pos - left)[..., None]
    return (1 - d) * cmap[left] + d * cmap[right]


def visualize_depth(depth: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """Depth (H,W) -> uint8 RGB via Spectral after min/max normalization."""
    vmin = np.min(depth) if vmin is None else vmin
    vmax = np.max(depth) if vmax is None else vmax
    norm = (depth - vmin) / max(vmax - vmin, 1e-8)
    return (spectral_colormap(norm) * 255).astype(np.uint8)


def decode_semantic(rgbish: np.ndarray, num_classes: int = 19):
    """Nearest-palette-color class decode of a 'semantic RGB' frame (H, W, 3)
    in [0, 255]. Returns (clean RGB uint8, class ids (H, W)). The fp32
    Euclidean distances are those of the JAX package's `np.linalg.norm` over
    an (H, W, classes, 3) array, taken one class at a time (the lowest class
    wins a tie, as argmin's first minimum), so the ids are equal without that
    array."""
    planes = [np.ascontiguousarray(rgbish[..., k], dtype=np.float32) for k in range(3)]
    best = ids = None
    for c, color in enumerate(SEMANTIC_PALETTE[:num_classes].astype(np.float32)):
        dist = None
        for plane, v in zip(planes, color):   # norm's sum over the 3 channels, in order
            d = plane - v
            dist = d * d if dist is None else dist + d * d
        np.sqrt(dist, out=dist)
        if best is None:
            best, ids = dist, np.zeros(dist.shape, np.int64)
        else:
            closer = dist < best
            np.minimum(best, dist, out=best)
            ids[closer] = c
    return SEMANTIC_PALETTE[:num_classes][ids], ids


def encode_semantic(class_ids: np.ndarray) -> np.ndarray:
    """Class ids -> palette RGB."""
    return SEMANTIC_PALETTE[class_ids.astype(np.int64)]


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8 RGB."""
    return np.clip((frames + 1) / 2 * 255, 0, 255).astype(np.uint8)


def imread(path: str) -> np.ndarray:
    """An image file as OpenCV reads it: (H, W, 3) uint8 in BGR order."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def save_image(path: str, img_uint8: np.ndarray):
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, cv2.cvtColor(img_uint8, cv2.COLOR_RGB2BGR))


def save_video(path: str, frames_uint8: np.ndarray, fps: int = 10):
    """Write (T, H, W, 3) uint8 RGB to mp4; a PNG directory when no codec is
    available."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _, h, w, _ = frames_uint8.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if writer.isOpened():
        for f in frames_uint8:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
    else:  # pragma: no cover
        base = os.path.splitext(path)[0]
        for i, f in enumerate(frames_uint8):
            save_image(os.path.join(base, f"{i:04d}.png"), f)


def side_by_side(*videos: np.ndarray) -> np.ndarray:
    """Horizontally concatenate (T,H,W,3) videos (compare-mp4 assembly,
    virtual_pose_render.py:357-366)."""
    return np.concatenate(videos, axis=2)
