"""Media I/O: PNG and mp4 writers and the semantic palette (copy of what the
port needs from `mudg_tpu/utils/media.py`). cv2 is imported by the writers
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


def decode_semantic(rgbish: np.ndarray, num_classes: int = 19):
    """Nearest-palette-color class decode of a 'semantic RGB' frame (H, W, 3)
    in [0, 255]. Returns (clean RGB uint8, class ids (H, W))."""
    pal = SEMANTIC_PALETTE[:num_classes].astype(np.float32)
    dist = np.linalg.norm(rgbish.astype(np.float32)[:, :, None, :] - pal[None, None], axis=3)
    ids = np.argmin(dist, axis=2)
    return SEMANTIC_PALETTE[:num_classes][ids], ids


def encode_semantic(class_ids: np.ndarray) -> np.ndarray:
    """Class ids -> palette RGB."""
    return SEMANTIC_PALETTE[class_ids.astype(np.int64)]


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
