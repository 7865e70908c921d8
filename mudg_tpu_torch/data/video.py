"""Generic video-clip dataset (the WebVid-style legacy path).

A copy of `mudg_tpu/data/video.py` (host code, OpenCV): the reference's
`lvdm/data/webvid.py` (WebVid, :13-202) without decord. It samples
fixed-length clips with a random frame stride from video files, resizes and
centre-crops them and scales them to [-1, 1]; its draws come from
`np.random.default_rng(seed)` in the JAX package's order. No MuDG recipe
uses it (they train on the Waymo multi-task dataset).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .waymo import resize_center_crop


def read_video_frames(path: str, indices: list[int]) -> np.ndarray:
    """Decode specific frame indices from a video file -> (N, H, W, 3) RGB."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        want = sorted(set(indices))
        got = {}
        pos = 0
        target = set(want)
        while want and pos <= want[-1]:
            ok, frame = cap.read()
            if not ok:
                break
            if pos in target:
                got[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            pos += 1
        return np.stack([got[i] for i in indices])
    finally:
        cap.release()


def video_frame_count(path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


@dataclass
class VideoClipDataset:
    """Clips of `video_length` frames with random stride in
    [frame_stride_min, frame_stride] (webvid.py frame-stride sampling)."""
    video_paths: list[str]
    captions: list[str] | None = None
    video_length: int = 16
    resolution: tuple = (256, 256)
    frame_stride: int = 4
    frame_stride_min: int = 1
    fps_base: int = 30
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.video_paths)

    def __getitem__(self, index: int) -> dict:
        path = self.video_paths[index % len(self.video_paths)]
        n = video_frame_count(path)
        stride = int(self._rng.integers(self.frame_stride_min, self.frame_stride + 1))
        span = (self.video_length - 1) * stride + 1
        if span > n:  # shrink stride to fit (webvid fallback behavior)
            stride = max((n - 1) // max(self.video_length - 1, 1), 1)
            span = (self.video_length - 1) * stride + 1
        start = int(self._rng.integers(0, max(n - span + 1, 1)))
        idxs = [start + i * stride for i in range(self.video_length)]
        frames = read_video_frames(path, idxs).astype(np.float32)
        frames = resize_center_crop(frames, self.resolution)
        frames = (frames / 255.0 - 0.5) * 2
        caption = (
            self.captions[index % len(self.captions)]
            if self.captions else "a video"
        )
        return {
            "dense_frames": frames,
            "caption": caption,
            "fps": max(self.fps_base // stride, 1),
            "frame_stride": stride,
        }
