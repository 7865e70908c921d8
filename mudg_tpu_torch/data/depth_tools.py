"""Depth densification utilities (the DepthLab stage's host math).

Copy of `mudg_tpu/data/depth_tools.py` in numpy (reference
`data_process/depthlab_tools.py`):
  * `align_depth`: least-squares scale/shift alignment of a predicted
    (relative) depth map to metric lidar depth (depthlab_tools.py:114-136),
  * `fill_sky`: sky pixels (cityscapes class 10) set to 100 m
    (process_sky, depthlab_tools.py:67-87),
  * `clamp_metric`: the [0, 100] clamp used across the pipeline,
  * `densify_classical`: a dependency-free densifier (iterative masked
    diffusion / hole filling), through OpenCV's filters where OpenCV is
    installed and plain numpy otherwise,
  * `densify_depth_map`: predict, align, fill the sky, clamp.
"""
from __future__ import annotations

import numpy as np

SKY_CLASS = 10        # cityscapes 'sky' (depthlab_tools.py:80)
SKY_DEPTH = 100.0
MAX_DEPTH = 100.0


def align_depth(pred: np.ndarray, sparse: np.ndarray, mask: np.ndarray | None = None):
    """Solve min ||a*pred + b - sparse||^2 over valid sparse pixels and return
    the aligned metric depth (depthlab_tools.py:114-136).

    pred: (H, W) relative depth; sparse: (H, W) metric lidar depth with 0 at
    holes; mask optionally restricts the fit."""
    valid = sparse > 0
    if mask is not None:
        valid &= mask.astype(bool)
    p = pred[valid].astype(np.float64)
    s = sparse[valid].astype(np.float64)
    if len(p) < 2:
        return pred.astype(np.float32), (1.0, 0.0)
    A = np.stack([p, np.ones_like(p)], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, s, rcond=None)
    return (a * pred + b).astype(np.float32), (float(a), float(b))


def fill_sky(depth: np.ndarray, semantic_ids: np.ndarray,
             sky_class: int = SKY_CLASS, sky_depth: float = SKY_DEPTH):
    """Set sky pixels to the far plane (depthlab_tools.py:67-87)."""
    out = depth.copy()
    out[semantic_ids == sky_class] = sky_depth
    return out


def clamp_metric(depth: np.ndarray, max_depth: float = MAX_DEPTH):
    return np.clip(depth, 0.0, max_depth)


def densify_classical(sparse: np.ndarray, iterations: int = 200,
                      kernel: int = 3) -> np.ndarray:
    """Dependency-free densification: masked averaging diffusion that fills
    holes from known lidar pixels while keeping the known pixels pinned.
    OpenCV's box filters where OpenCV is installed, else the same filling
    in numpy (without the final smoothing pass)."""
    try:
        import cv2
    except ImportError:
        cv2 = None

    known = sparse > 0
    if known.sum() == 0:
        return np.zeros_like(sparse, np.float32)

    d = sparse.astype(np.float32).copy()
    m = known.astype(np.float32)
    if cv2 is not None:
        k = np.ones((kernel, kernel), np.float32)
        for _ in range(iterations):
            num = cv2.filter2D(d * m, -1, k, borderType=cv2.BORDER_REPLICATE)
            den = cv2.filter2D(m, -1, k, borderType=cv2.BORDER_REPLICATE)
            filled = num / np.maximum(den, 1e-6)
            newly = (den > 0) & (m == 0)
            d = np.where(newly, filled, d)
            m = np.maximum(m, newly.astype(np.float32))
            if m.all():
                break
        # smoothing pass on the filled regions only
        sm = cv2.blur(d, (kernel, kernel))
        d = np.where(known, sparse, sm)
    else:
        for _ in range(iterations):
            padded = np.pad(d * m, 1, mode="edge")
            pm = np.pad(m, 1, mode="edge")
            num = sum(
                padded[1 + dy: padded.shape[0] - 1 + dy,
                       1 + dx: padded.shape[1] - 1 + dx]
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            )
            den = sum(
                pm[1 + dy: pm.shape[0] - 1 + dy, 1 + dx: pm.shape[1] - 1 + dx]
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            )
            filled = num / np.maximum(den, 1e-6)
            newly = (den > 0) & (m == 0)
            d = np.where(newly, filled, d)
            m = np.maximum(m, newly.astype(np.float32))
            if m.all():
                break
        d = np.where(known, sparse, d)
    return d.astype(np.float32)


def densify_depth_map(sparse: np.ndarray, semantic_ids: np.ndarray | None = None,
                      predictor=None) -> np.ndarray:
    """Full densification step mirroring generate_depth_map
    (depthlab_tools.py:317-344): predict (a learned predictor or the
    classical fallback), lstsq-align to the lidar points, fill sky, clamp."""
    if predictor is not None:
        pred = predictor(sparse)
    else:
        pred = densify_classical(sparse)
    aligned, _ = align_depth(pred, sparse)
    if semantic_ids is not None:
        aligned = fill_sky(aligned, semantic_ids)
    return clamp_metric(aligned)
