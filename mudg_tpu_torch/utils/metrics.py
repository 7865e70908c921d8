"""Image and map quality metrics: PSNR, SSIM, depth metrics, mIoU.

Port of `mudg_tpu/utils/metrics.py`. PSNR, the depth metrics and mIoU are
numpy on the host (copies); SSIM goes through the port's `gs/train.ssim` on
the device its caller names.
"""
from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """PSNR between two arrays (default range 2.0 for [-1, 1] images)."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def ssim(a: np.ndarray, b: np.ndarray, device="cpu") -> float:
    """Single-scale SSIM on (H, W, C) images in [0, 1], in fp32 on `device`
    (`gs/train.ssim`)."""
    import torch

    from ..gs.train import ssim as _ssim

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)

    return float(_ssim(t(a), t(b)))


def depth_metrics(pred: np.ndarray, gt: np.ndarray,
                  mask: np.ndarray | None = None) -> dict:
    """Standard monocular-depth metrics over valid pixels (gt > 0 unless a
    mask is given): abs_rel, rmse, delta1 (ratio < 1.25)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    m = (gt > 0) if mask is None else (np.asarray(mask, bool) & (gt > 0))
    if not m.any():
        return {"abs_rel": None, "rmse": None, "delta1": None, "n_valid": 0}
    p, g = pred[m], gt[m]
    ratio = np.maximum(p / np.maximum(g, 1e-9), g / np.maximum(p, 1e-9))
    return {
        "abs_rel": float(np.mean(np.abs(p - g) / np.maximum(g, 1e-9))),
        "rmse": float(np.sqrt(np.mean((p - g) ** 2))),
        "delta1": float(np.mean(ratio < 1.25)),
        "n_valid": int(m.sum()),
    }


def miou(pred_ids: np.ndarray, gt_ids: np.ndarray, n_classes: int) -> dict:
    """Mean IoU + pixel accuracy over integer class-id maps; classes absent
    from both prediction and GT are excluded from the mean."""
    pred_ids = np.asarray(pred_ids).ravel()
    gt_ids = np.asarray(gt_ids).ravel()
    ious = []
    for c in range(n_classes):
        inter = np.sum((pred_ids == c) & (gt_ids == c))
        union = np.sum((pred_ids == c) | (gt_ids == c))
        if union:
            ious.append(inter / union)
    return {
        "miou": float(np.mean(ious)) if ious else None,
        "pixel_acc": float(np.mean(pred_ids == gt_ids)),
        "n_classes_present": len(ious),
    }


def video_psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0):
    """Per-frame + mean PSNR over (T, H, W, C) videos."""
    per = [psnr(a[i], b[i], data_range) for i in range(len(a))]
    return float(np.mean(per)), per
